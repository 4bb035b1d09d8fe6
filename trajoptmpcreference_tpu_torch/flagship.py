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

The torque-limited variant (``__graft_entry__._flagship``'s
``torque_limit`` / ``torque_mode``, bench.py:104-127) puts box limits on
all six torques: ``AS_KNOBS`` hard ACTIVE_SET rows (the condensed Schur
path), ``AL_KNOBS`` an augmented-Lagrangian penalty with one outer round
per control step; both at 4 SQP iterations.

The iLQR variant (``__graft_entry__._flagship`` with method="iLQR",
bench.py:81-90) keeps the plant, cost and options and solves each control
step by iLQR (``ILQR_KNOBS``: 5 iterations a step; the cold step's 4
iterations and 9-rung ladder as for SQP, its exact_schur unused).

``run_episode(..., use_lanes=False)`` runs the same loop on the arm's
per-sample plant (``URDFPlant(use_lanes=False)``: ops/rbd.py and the
per-sample kinematics, no kernel), with the cost weights, constraints and
solver settings of the lanes flagship's own solvers.

``RK4_KNOBS`` integrates the arm by RK4 instead of semi-implicit Euler
(``integrator_type=4``): four dynamics evaluations a step, so each KKT
assembly launches K1 four times and K2 seven times.  The RTI knobs
(``ls_fixed_alpha``, ``rti_lean``, ``rti_step_clip``) replace the line
search by a fixed step.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from trajoptmpcreference_tpu_torch.convert import require_device
from trajoptmpcreference_tpu_torch.models.plants import URDFPlant
from trajoptmpcreference_tpu_torch.models.urdf import serial_arm
from trajoptmpcreference_tpu_torch.solvers.constraints import ConstraintSet
from trajoptmpcreference_tpu_torch.solvers.costs import UrdfCost
from trajoptmpcreference_tpu_torch.solvers.ilqr import make_ilqr
from trajoptmpcreference_tpu_torch.solvers.mpc import MPCController, run_scheduled
from trajoptmpcreference_tpu_torch.solvers.sqp import SQPOptions, make_sqp

# the cold phase of bench.py:163-184: one step, 4 iterations, 9-rung ladder,
# block-Thomas exact solves
COLD_KNOBS = dict(max_iter=4, alpha_min=0.005, alpha_factor=0.5,
                  exact_schur="thomas")
# the PCG flagship (__graft_entry__.py:34-39: "method="PCG-SS",
# pcg_iters=40, max_iter=4 reproduces the round-2 PCG flagship")
PCG_KNOBS = dict(method="PCG-SS", max_iter=4, pcg_iters=40)
# the torque-limited flagship, bench.py:104-125's defaults for
# BENCH_TORQUE_LIMIT=6 with BENCH_TORQUE_MODE=ACTIVE_SET or the default
# AUGMENTED_LAGRANGIAN (one AL outer round per control step)
AS_KNOBS = dict(torque_limit=6.0, torque_mode="ACTIVE_SET", max_iter=4)
AL_KNOBS = dict(torque_limit=6.0, torque_mode="AUGMENTED_LAGRANGIAN",
                max_iter=4, max_iter_soft=1)
# the iLQR flagship, bench.py:81-90's default for BENCH_METHOD=iLQR
ILQR_KNOBS = dict(method="iLQR", max_iter=5)
# the flagship with the arm integrated by RK4 (__graft_entry__.py:23's
# integrator_type)
RK4_KNOBS = dict(integrator_type=4)
DT = 0.015
# the simulated arm's joint velocity limit: half a turn per control step
SIM_QD_MAX = math.pi / DT


def flagship(N=64, max_iter=3, dtype=torch.float32, device="cuda",
             use_kernels=True, exact_schur="cr", alpha_min=0.11,
             alpha_factor=0.316, method="S", pcg_iters=40, pcg_tol=1e-4,
             use_kernel_pcg=False, torque_limit=0.0,
             torque_mode="AUGMENTED_LAGRANGIAN", torque_band=0.2,
             max_iter_soft=None, ls_step_clip=math.inf,
             parallel_riccati=False, integrator_type=1, vel_weight=0.1,
             r_weight=0.01, qf_weight=100.0, dt=DT, parallel_ls=True,
             ls_grad_at_base=True, ls_fixed_alpha=0.0, rti_lean=False,
             rti_step_clip=math.inf, rho_init=1e-3, rho_min=1e-3):
    """(plant, cost, solver) with the knobs and defaults of
    __graft_entry__._flagship (:19-29); its rule that turns the fd and
    task kernels off under the sequential line search (:76-81) works round
    an XLA:TPU fault and is not ported.  torque_limit > 0 bounds every torque
    to +-torque_limit in ``torque_mode`` (a hard or soft mode, or
    "ACTIVE_SET+AL": hard rows with activation band ``torque_band`` and an
    AL limit stacked on the same bound, __graft_entry__.py:150-170);
    max_iter_soft caps the AL outer rounds per solve; ls_step_clip bounds
    max|dU| of each QP direction.  method="iLQR" builds the iLQR solver
    (soft torque modes only; ``parallel_riccati`` picks the log-depth
    backward pass, the bench's BENCH_ILQR_PARALLEL; exact_schur and the
    PCG knobs are unused).
    use_kernels selects K1 / K2 / K3 on CUDA tensors (the JAX flagship's
    use_pallas / use_pallas_fd / use_pallas_task); use_kernel_pcg routes
    the PCG methods through the fused PCG, K4 on CUDA tensors (the JAX
    use_pallas_pcg).  The tensors go to ``device``, the card unless the
    caller asks for another; without CUDA the default raises."""
    device = require_device(device)
    plant = URDFPlant(robot=serial_arm(6), integrator_type=integrator_type,
                      use_kernel_fd_grad=use_kernels, use_kernel_fd=use_kernels,
                      use_kernel_task=use_kernels)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    # the arm is planar; goals live in the reachable x-y disc (z ignored = 0)
    w = vel_weight
    cost = UrdfCost(plant,
                    torch.diag(t([1.0, 1.0, 1.0, w, w, w])),
                    qf_weight * torch.eye(6, dtype=dtype, device=device),
                    r_weight * torch.eye(plant.nu, dtype=dtype, device=device),
                    t([3.0, 2.0, 0.0, 0.0, 0.0, 0.0]))
    opts = SQPOptions(
        expected_reduction_min=-100.0,   # per the reference's own example
        exit_tolerance=1e-4,             # f32-safe
        exit_tolerance_linSys=pcg_tol,   # PCG fields: unused by method "S"
        max_iter=max_iter,
        max_iter_linSys=pcg_iters,
        pcg_relative=True,
        parallel_line_search=parallel_ls,
        alpha_factor=alpha_factor,
        alpha_min=alpha_min,
        ls_grad_at_base=ls_grad_at_base,
        ls_fixed_alpha=ls_fixed_alpha,   # > 0: RTI, no line search
        rti_lean=rti_lean,
        rti_step_clip=rti_step_clip,
        rho_init=rho_init,
        rho_min=rho_min,
        ls_step_clip=ls_step_clip,
        **({} if max_iter_soft is None else dict(max_iter_soft=max_iter_soft)),
    )
    cset = None
    if torque_limit > 0:
        cset = ConstraintSet(plant.nq, plant.nv, plant.nu, N)
        if torque_mode == "ACTIVE_SET+AL":
            cset = cset.with_torque_limits(torque_limit, -torque_limit,
                                           "ACTIVE_SET",
                                           activation_band=torque_band)
            cset = cset.with_torque_limits(torque_limit, -torque_limit,
                                           "AUGMENTED_LAGRANGIAN")
        else:
            cset = cset.with_torque_limits(torque_limit, -torque_limit,
                                           torque_mode)
    if method == "iLQR":
        # __graft_entry__.py:174-192: a hard torque mode is rejected, never
        # dropped (iLQR has no active-set machinery)
        if cset is not None and cset.has_hard():
            raise ValueError(
                f"iLQR supports soft torque limits only; got torque_mode="
                f"{torque_mode!r} (use AUGMENTED_LAGRANGIAN or "
                "QUADRATIC_PENALTY, ref: README.md:17)")
        solver = make_ilqr(plant, cost, cset, N, dt, options=opts,
                           parallel_riccati=parallel_riccati)
        return plant, cost, solver
    solver = make_sqp(plant, cost, cset, N, dt, method=method, options=opts,
                      exact_schur=exact_schur, use_kernel_pcg=use_kernel_pcg)
    return plant, cost, solver


def flagship_mpc(sim_qd_max=SIM_QD_MAX, **knobs):
    """(plant, cost, MPCController) around ``flagship(**knobs)``.

    The simulated arm's joints are limited to ``sim_qd_max``, by default
    pi / dt rad/s, half a turn per control step (the port's own; the
    reference has none: ``math.inf``).  Past it semi-implicit Euler no
    longer follows the arm: its explicit velocity-product terms make the
    speed grow by orders of magnitude per step until f32 overflows, under
    torques of ~2 N m.  No scenario that stays under the limit changes
    (PERF.md section 6)."""
    plant, cost, solver = flagship(**knobs)
    return plant, cost, MPCController(solver=solver, sim_plant=plant,
                                      sim_qd_max=sim_qd_max)


def bench_scenarios(B: int, seed: int = 0):
    """Initial states (B, 12) and goals (B, 6) drawn exactly as
    bench.py:193-198 draws them."""
    rng = np.random.default_rng(seed)
    x0s = 0.1 * rng.standard_normal((B, 12))
    goals = np.concatenate([
        np.array([3.0, 2.0, 0.0]) + 0.3 * rng.standard_normal((B, 3)) * [1, 1, 0],
        np.zeros((B, 3))], axis=1)
    return x0s, goals


def per_sample(ctrl: MPCController) -> MPCController:
    """The SQP controller ``ctrl`` on the per-sample plant of its arm
    (``URDFPlant(robot, use_lanes=False)``, the same integrator): the same
    cost weights, constraint set, horizon, method, SQPOptions and Schur
    solve, read from ``ctrl``'s own solver so that the two cannot drift."""
    s = ctrl.solver
    plant = URDFPlant(robot=s.plant.robot, use_lanes=False,
                      integrator_type=s.plant.integrator_type)
    cost = UrdfCost(plant, *s.cost.default_params)
    solver = make_sqp(plant, cost, s.cset, s.N, s.dt, method=s.method,
                      options=s.options, exact_schur=s.kkt.exact_schur,
                      use_kernel_pcg=s.kkt.use_kernel_pcg)
    return dataclasses.replace(ctrl, solver=solver, sim_plant=plant)


def run_episode(x0s, goals, steps=150, cold_steps=1, use_lanes=True, **knobs):
    """The bench's scheduled closed loop: ``cold_steps`` steps of the cold
    controller (COLD_KNOBS over ``knobs``), then the steady flagship
    controller.  x0s (B, 12) and goals (B, 6) are tensors on the target
    device; knobs go to ``flagship_mpc``.  ``use_lanes=False`` runs both
    controllers on the per-sample plant (``per_sample``; SQP methods)."""
    knobs = dict(knobs, dtype=x0s.dtype, device=x0s.device)
    plant, cost, ctrl = flagship_mpc(**knobs)
    _, _, ctrl_cold = flagship_mpc(**{**knobs, **COLD_KNOBS})
    if not use_lanes:
        ctrl, ctrl_cold = per_sample(ctrl), per_sample(ctrl_cold)
        plant = ctrl.plant
    params = cost.default_params._replace(xg=goals)
    nc = min(cold_steps, steps)
    phases = [(ctrl_cold, nc)] + ([(ctrl, steps - nc)] if steps > nc else [])
    return plant, run_scheduled(phases, x0s, cost_params=params)


def ee_errors(plant, x0s, goals, res):
    """(final EE distance to goal, initial EE distance) per scenario, in the
    goal's x-y plane (bench.py:236-243), as float64 numpy arrays."""
    ee = plant.kinematics.ee_pos_x(res.X_applied[..., -1])
    ee0 = plant.kinematics.ee_pos_x(x0s)
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
