"""trajoptmpcreference_tpu_torch — the PyTorch + CUDA port of
trajoptmpcreference_tpu, slice by slice.

This slice runs the flagship MPC closed loop: URDF robot models, lanes
rigid-body dynamics and kinematics with hand-written CUDA kernels (K1
fd_grad, K2 fd, K3 task residual) on the card, Euler / semi-implicit
integrators, the task-space cost, SQP method "S" with the exact split
Schur solve (cyclic reduction or block-Thomas) and the receding-horizon
loop.  Every function takes the scenario batch as an explicit leading
dimension.  The package imports torch and numpy, never jax.
"""

__version__ = "0.1.0"

from trajoptmpcreference_tpu_torch.models.robot import RobotModel
from trajoptmpcreference_tpu_torch.models.urdf import parse_urdf, serial_arm
from trajoptmpcreference_tpu_torch.models.plants import Plant, URDFPlant
from trajoptmpcreference_tpu_torch.solvers.costs import (
    Cost,
    QuadraticCostParams,
    UrdfCost,
)
from trajoptmpcreference_tpu_torch.solvers.constraints import ConstraintSet
from trajoptmpcreference_tpu_torch.solvers.sqp import (
    SQPOptions,
    SQPResult,
    SQPSolver,
    make_sqp,
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

__all__ = [
    "RobotModel", "parse_urdf", "serial_arm", "Plant", "URDFPlant", "Cost",
    "QuadraticCostParams", "UrdfCost", "ConstraintSet", "SQPOptions",
    "SQPResult", "SQPSolver", "make_sqp", "SQPSolverMethods",
    "MPCSolverMethods", "MPCController", "MPCResult", "make_mpc",
    "run_scheduled",
]
