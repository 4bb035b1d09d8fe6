"""trajoptmpcreference_tpu_torch — the PyTorch + CUDA port of
trajoptmpcreference_tpu, slice by slice.

It runs the flagship MPC closed loop: URDF robot models and the analytic
plants (double integrator, pendulum, cart-pole), lanes rigid-body
dynamics and kinematics with hand-written CUDA kernels (K1 fd_grad, K2 fd,
K3 task residual) on the card, the five integrators (Euler, semi-implicit
Euler, midpoint, RK3, RK4, with exact gradients), the
quadratic, task-space (every Hessian mode), numerical and closed-form arm
costs, box limits on joints, velocities and torques in every
mode (hard ACTIVE_SET / FULL_SET rows, QUADRATIC_PENALTY and
AUGMENTED_LAGRANGIAN soft limits), SQP methods "N" (the dense KKT
system), "S" (the exact Schur solve
by cyclic reduction or block-Thomas, on the split, condensed or generic
assembly) and "PCG-J" / "PCG-BJ" / "PCG-SS" (the Schur system by
preconditioned CG, optionally through the fused PCG kernel K4), iLQR
(sequential or log-depth Riccati pass, soft constraints), the real-time
iteration (``ls_fixed_alpha``, ``rti_lean``, ``rti_step_clip``) and the
receding-horizon loop, with the torque-limited, iLQR and RK4 flagship
variants (``AS_KNOBS``, ``AL_KNOBS``, ``ILQR_KNOBS``, ``RK4_KNOBS``).  The
per-sample rigid-body dynamics (RNEA and its gradient, Minv, CRBA, ABA,
IDSVA), spatial algebra and kinematics (``ops/rbd.py``, ``ops/spatial.py``,
``ops/kinematics.Kinematics``) run ``URDFPlant(use_lanes=False)`` and hold
the kernels to another formulation; ``utils`` has the SQP trace, the
operation count and the timer.  ``parallel`` splits scenario batches and
shards the Schur solve over the horizon across processes
(``torch.distributed``: NCCL on cards, gloo on CPUs), and ``native`` is
the robot-specialized C++ dynamics (g++, ctypes).  ``examples`` holds
the JAX package's example scripts, run as ``python -m
trajoptmpcreference_tpu_torch.examples.<name>``.  Every function takes
the scenario batch as an explicit leading dimension.  The package
imports torch and numpy, never jax.
"""

__version__ = "0.8.0"

from trajoptmpcreference_tpu_torch.models.robot import RobotModel
from trajoptmpcreference_tpu_torch.models.urdf import parse_urdf, serial_arm
from trajoptmpcreference_tpu_torch.models.plants import (
    CartPolePlant,
    DoubleIntegratorPlant,
    PendulumPlant,
    Plant,
    URDFPlant,
)
from trajoptmpcreference_tpu_torch.ops.btridiag import pcg, preconditioner
from trajoptmpcreference_tpu_torch.ops.fused_pcg import make_batched_pcg
from trajoptmpcreference_tpu_torch.solvers.costs import (
    ArmCost,
    Cost,
    NumericalCost,
    QuadraticCost,
    QuadraticCostParams,
    UrdfCost,
    total_cost_diff,
)
from trajoptmpcreference_tpu_torch.solvers.constraints import (
    BoxLimitSpec,
    ConstraintSet,
    SoftLimitState,
)
from trajoptmpcreference_tpu_torch.solvers.sqp import (
    SQPOptions,
    SQPResult,
    SQPSolver,
    make_sqp,
)
from trajoptmpcreference_tpu_torch.solvers.ilqr import (
    ILQRResult,
    ILQRSolver,
    make_ilqr,
)
from trajoptmpcreference_tpu_torch.solvers.methods import (
    MPCSolverMethods,
    SQPSolverMethods,
)
from trajoptmpcreference_tpu_torch.solvers.mpc import (
    MPCController,
    MPCResult,
    make_mpc,
    run_scheduled,
)
from trajoptmpcreference_tpu_torch.flagship import (
    AL_KNOBS,
    AS_KNOBS,
    ILQR_KNOBS,
    RK4_KNOBS,
)

__all__ = [
    "RobotModel", "parse_urdf", "serial_arm", "Plant", "URDFPlant",
    "DoubleIntegratorPlant", "PendulumPlant", "CartPolePlant", "Cost",
    "QuadraticCostParams", "QuadraticCost", "UrdfCost", "NumericalCost",
    "ArmCost", "total_cost_diff", "ConstraintSet", "BoxLimitSpec",
    "SoftLimitState", "AS_KNOBS", "AL_KNOBS", "ILQR_KNOBS", "RK4_KNOBS",
    "ILQRResult",
    "ILQRSolver", "make_ilqr", "SQPOptions",
    "SQPResult", "SQPSolver", "make_sqp", "SQPSolverMethods",
    "MPCSolverMethods", "MPCController", "MPCResult", "make_mpc",
    "run_scheduled", "pcg", "preconditioner", "make_batched_pcg",
]
