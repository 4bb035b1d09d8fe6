"""The flagship closed loop: 6-DoF serial arm, horizon 64, task-space cost,
SQP in the MPC regime — the configuration bench.py measures
(``__graft_entry__._flagship`` / ``_flagship_mpc``, bench.py:135-198),
built from the port with the same defaults.

An episode runs one cold step (4 SQP iterations, block-Thomas Schur solves,
the 9-rung ladder alpha_factor 0.5 / alpha_min 0.005) and then steady steps
(3 iterations, cyclic reduction, the parallel 3-rung ladder [1, .316, .1]
with the Armijo derivative at the base point), chained by run_scheduled.
With ``PCG_KNOBS`` (the bench's BENCH_METHOD=PCG-SS BENCH_SQP_ITERS=4) both
phases take 4 iterations and solve the Schur system by PCG-SS, 40 PCG
iterations at a relative tolerance of 1e-4.
"""

from __future__ import annotations

import numpy as np
import torch

from trajoptmpcreference_tpu_torch.convert import require_device
from trajoptmpcreference_tpu_torch.models.plants import URDFPlant
from trajoptmpcreference_tpu_torch.models.urdf import serial_arm
from trajoptmpcreference_tpu_torch.solvers.costs import UrdfCost
from trajoptmpcreference_tpu_torch.solvers.mpc import MPCController, run_scheduled
from trajoptmpcreference_tpu_torch.solvers.sqp import SQPOptions, make_sqp

# the cold phase of bench.py:163-184: one step, 4 iterations, 9-rung ladder,
# block-Thomas exact solves
COLD_KNOBS = dict(max_iter=4, alpha_min=0.005, alpha_factor=0.5,
                  exact_schur="thomas")
# the PCG flagship (__graft_entry__.py:34-39: "method="PCG-SS",
# pcg_iters=40, max_iter=4 reproduces the round-2 PCG flagship")
PCG_KNOBS = dict(method="PCG-SS", max_iter=4, pcg_iters=40)


def flagship(N=64, max_iter=3, dtype=torch.float32, device="cuda",
             use_kernels=True, exact_schur="cr", alpha_min=0.11,
             alpha_factor=0.316, method="S", pcg_iters=40, pcg_tol=1e-4,
             use_kernel_pcg=False):
    """(plant, cost, solver) with the defaults of __graft_entry__._flagship
    (the knobs are those the cold phase and the PCG variant change).
    use_kernels selects K1 / K2 / K3 on CUDA tensors (the JAX flagship's
    use_pallas / use_pallas_fd / use_pallas_task); use_kernel_pcg routes
    the PCG methods through the fused PCG, K4 on CUDA tensors (the JAX
    use_pallas_pcg).  The tensors go to ``device``, the card unless the
    caller asks for another; without CUDA the default raises."""
    device = require_device(device)
    plant = URDFPlant(robot=serial_arm(6), integrator_type=1,
                      use_kernel_fd_grad=use_kernels, use_kernel_fd=use_kernels,
                      use_kernel_task=use_kernels)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    # the arm is planar; goals live in the reachable x-y disc (z ignored = 0)
    cost = UrdfCost(plant,
                    torch.diag(t([1.0, 1.0, 1.0, 0.1, 0.1, 0.1])),
                    100.0 * torch.eye(6, dtype=dtype, device=device),
                    0.01 * torch.eye(plant.nu, dtype=dtype, device=device),
                    t([3.0, 2.0, 0.0, 0.0, 0.0, 0.0]))
    opts = SQPOptions(
        expected_reduction_min=-100.0,   # per the reference's own example
        exit_tolerance=1e-4,             # f32-safe
        exit_tolerance_linSys=pcg_tol,   # PCG fields: unused by method "S"
        max_iter=max_iter,
        max_iter_linSys=pcg_iters,
        pcg_relative=True,
        parallel_line_search=True,
        alpha_factor=alpha_factor,
        alpha_min=alpha_min,
        ls_grad_at_base=True,
        rho_init=1e-3,
        rho_min=1e-3,
    )
    solver = make_sqp(plant, cost, None, N, 0.015, method=method, options=opts,
                      exact_schur=exact_schur, use_kernel_pcg=use_kernel_pcg)
    return plant, cost, solver


def flagship_mpc(**knobs):
    """(plant, cost, MPCController) around ``flagship(**knobs)``."""
    plant, cost, solver = flagship(**knobs)
    return plant, cost, MPCController(solver=solver, sim_plant=plant)


def bench_scenarios(B: int, seed: int = 0):
    """Initial states (B, 12) and goals (B, 6) drawn exactly as
    bench.py:193-198 draws them."""
    rng = np.random.default_rng(seed)
    x0s = 0.1 * rng.standard_normal((B, 12))
    goals = np.concatenate([
        np.array([3.0, 2.0, 0.0]) + 0.3 * rng.standard_normal((B, 3)) * [1, 1, 0],
        np.zeros((B, 3))], axis=1)
    return x0s, goals


def run_episode(x0s, goals, steps=150, cold_steps=1, **knobs):
    """The bench's scheduled closed loop: ``cold_steps`` steps of the cold
    controller, then the steady flagship controller.  x0s (B, 12) and goals
    (B, 6) are tensors on the target device; knobs go to ``flagship``."""
    knobs = dict(knobs, dtype=x0s.dtype, device=x0s.device)
    plant, cost, ctrl = flagship_mpc(**knobs)
    _, _, ctrl_cold = flagship_mpc(**{**knobs, **COLD_KNOBS})
    params = cost.default_params._replace(xg=goals)
    nc = min(cold_steps, steps)
    phases = [(ctrl_cold, nc)] + ([(ctrl, steps - nc)] if steps > nc else [])
    return plant, run_scheduled(phases, x0s, cost_params=params)


def ee_errors(plant, x0s, goals, res):
    """(final EE distance to goal, initial EE distance) per scenario, in the
    goal's x-y plane (bench.py:236-243), as float64 numpy arrays."""
    kin, n = plant.kinematics, plant.nq
    ee = kin.ee_pos_xyz(res.X_applied[:, :n, -1].T.contiguous())[:2].T
    ee0 = kin.ee_pos_xyz(x0s[:, :n].T.contiguous())[:2].T
    err = torch.linalg.norm(ee - goals[:, :2], dim=1)
    dist0 = torch.linalg.norm(ee0 - goals[:, :2], dim=1)
    return (err.double().cpu().numpy(), dist0.double().cpu().numpy())


def quality_gate(err, dist0):
    """The bench's gate: median final EE error < 0.25 x the median initial
    distance; 'stable' = finite and final error < 1 m (bench.py:244-247)."""
    finite = np.isfinite(err)
    stable = int((finite & (err < 1.0)).sum())
    med_err = float(np.median(np.where(finite, err, np.inf)))
    return med_err < 0.25 * float(np.median(dist0)), med_err, stable
