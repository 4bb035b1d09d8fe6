"""The port's constrained SQP on the 2-link arm, against the reference's
golden run and the JAX package (f64 on the CPU).

* ``arm2_S_active_set``: hard ACTIVE_SET torque limits of +-0.2, method S,
  ``ref_compat``: the bar of tests/test_sqp_parity.py:150-175 (controls
  and states to 1e-4 of the reference's, |U| <= 0.2 + 1e-6).
* tests/test_baseline_configs.py:89's PCG-SS solve with AL joint limits of
  +-1.1: its asserts, and the controls against JAX's to 1e-8.
* ``ls_step_clip`` and ``hard_violation_exit_tol`` on
  tests/test_constraints.py's chatter configuration (N = 16, +-0.5 torque
  ACTIVE_SET with its activation band of 0.05), B = 3 goals: controls
  against JAX's to 1e-8, equal exit codes and iteration counts; the clip
  is taken per scenario.  Without the band, rows clamped exactly onto the
  bound flip on rounding, in either package, and the two chatter apart.
* One test per repaired fault: the soft outer loop froze no state (a
  scenario's result depended on its batchmates, and the state moved on
  the round a scenario exited); the MPC watchdog kept the soft state;
  ``hard_violation_exit_tol`` was accepted and never read.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajoptmpcreference_tpu import (
    ConstraintSet as JConstraintSet,
    SQPOptions as JSQPOptions,
    URDFPlant as JURDFPlant,
    UrdfCost as JUrdfCost,
    make_sqp as jmake_sqp,
    serial_arm as jserial_arm,
)
from trajoptmpcreference_tpu_torch import (
    ConstraintSet,
    SQPOptions,
    URDFPlant,
    UrdfCost,
    make_sqp,
    serial_arm,
)
from trajoptmpcreference_tpu_torch import convert
from trajoptmpcreference_tpu_torch import flagship as F
from trajoptmpcreference_tpu_torch.solvers import constraints as TC
from trajoptmpcreference_tpu_torch.solvers.mpc import MPCController

GOLDEN = pathlib.Path(__file__).parent / "golden"
f64 = torch.float64
GOAL = [0.5, 1.5, 0.0, 0.0]
# a reach into the elbow limit, one past it, one inside the workspace
GOALS = np.array([GOAL, [1.0, 1.2, 0.0, 0.0], [0.8, 1.5, 0.0, 0.0]])


def _arm2(goal=GOAL, ref_compat=False):
    """(port cost, JAX cost) of the arm2 task-space reach."""
    t = lambda a: torch.tensor(a, dtype=f64)
    plant = URDFPlant(robot=serial_arm(2))
    cost = UrdfCost(plant, torch.eye(4, dtype=f64), 100.0 * torch.eye(4, dtype=f64),
                    0.1 * torch.eye(2, dtype=f64), t(goal), ref_compat=ref_compat)
    jplant = JURDFPlant(robot=jserial_arm(2))
    jcost = JUrdfCost(jplant, jnp.eye(4), 100.0 * jnp.eye(4), 0.1 * jnp.eye(2),
                      jnp.asarray(goal), ref_compat=ref_compat)
    return plant, cost, jplant, jcost


def _solve_both(build_cs, N, dt, method, opts, goals=GOALS):
    """Solve the B goals from rest in both packages; returns (port result,
    JAX result, port solver)."""
    plant, cost, jplant, jcost = _arm2()
    jcs = build_cs(JConstraintSet(2, 2, 2, N))
    cs = convert.constraint_set_from_numpy(jcs)
    assert cs == build_cs(ConstraintSet(2, 2, 2, N))
    js = jmake_sqp(jplant, jcost, jcs, N, dt, method=method,
                   options=JSQPOptions(**opts))
    s = make_sqp(plant, cost, cs, N, dt, method=method,
                 options=SQPOptions(**opts))
    B = len(goals)
    cps = jax.vmap(lambda g: jcost.default_params._replace(xg=g))(
        jnp.asarray(goals))
    ref = jax.jit(jax.vmap(js.solve))(jnp.zeros((B, 4, N)),
                                      jnp.zeros((B, 2, N - 1)), cps)
    res = s.solve(torch.zeros((B, 4, N), dtype=f64),
                  torch.zeros((B, 2, N - 1), dtype=f64),
                  cost.default_params._replace(xg=torch.tensor(goals)))
    return res, ref, s


def _assert_matches(res, ref, tol):
    for field in ("exit_sqp", "sqp_iters", "exit_soft", "outer_iters"):
        np.testing.assert_array_equal(getattr(res, field).numpy(),
                                      np.asarray(getattr(ref, field)), field)
    assert np.abs(res.U.numpy() - np.asarray(ref.U)).max() < tol
    X = np.asarray(ref.X)
    assert np.abs(res.X.numpy() - X).max() < tol * np.abs(X).max()


def test_arm2_S_active_set_matches_reference_golden():
    gold = np.load(GOLDEN / "arm2_S_active_set.npz")
    plant, cost, _, _ = _arm2(ref_compat=True)
    cs = ConstraintSet(2, 2, 2, 10).with_torque_limits(0.2, -0.2, "ACTIVE_SET")
    s = make_sqp(plant, cost, cs, 10, 0.1, method="S",
                 options=SQPOptions(expected_reduction_min=-100.0))
    assert s.kkt._can_condense_hard()
    res = s.solve(torch.zeros((1, 4, 10), dtype=f64),
                  torch.zeros((1, 2, 9), dtype=f64))
    assert int(res.exit_sqp[0]) == int(gold["exit_sqp"])
    np.testing.assert_allclose(res.U[0].numpy(), gold["u"], atol=1e-4)
    np.testing.assert_allclose(res.X[0].numpy(), gold["x"], atol=1e-4)
    assert np.abs(res.U.numpy()).max() <= 0.2 + 1e-6
    assert res.lam.shape == (1, 10, 4 + 4)


def test_arm2_pcg_al_joint_limits():
    """tests/test_baseline_configs.py:89 in the port, and against JAX."""
    N = 10
    plant, cost, _, _ = _arm2()
    opts = dict(expected_reduction_min=-100.0)
    free = make_sqp(plant, cost, None, N, 0.1, method="PCG-SS",
                    options=SQPOptions(**opts))
    rf = free.solve(torch.zeros((1, 4, N), dtype=f64),
                    torch.zeros((1, 2, N - 1), dtype=f64))
    assert float(rf.X[0, 1].abs().max()) > 1.2      # the limit binds
    res, ref, s = _solve_both(
        lambda cs: cs.with_joint_limits(1.1, -1.1, "AUGMENTED_LAGRANGIAN"),
        N, 0.1, "PCG-SS", opts, goals=GOALS[:1])
    assert int(res.exit_soft[0]) in (1, 2, 3)
    assert float(res.X[0, :2].abs().max()) <= 1.1 * 1.05
    ee = plant.kinematics.ee_pos_xyz(res.X[0, :2, -1:].contiguous())[:2, 0]
    assert float(torch.linalg.norm(ee - torch.tensor(GOAL[:2], dtype=f64))) < 0.3
    _assert_matches(res, ref, 1e-8)
    for a, b in zip(res.cstate[0], ref.cstate[0]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9, atol=1e-9)


CHATTER = lambda cs: cs.with_torque_limits(0.5, -0.5, "ACTIVE_SET",
                                           activation_band=0.05)
CHATTER_OPTS = dict(expected_reduction_min=-100.0, max_iter=40)


def test_ls_step_clip_matches_jax_per_scenario():
    """The clip rescales each scenario's QP direction by its own max|dU|:
    the port equals JAX, the clip changes the solve, and scenario 0 solved
    alone equals scenario 0 in the batch."""
    opts = dict(CHATTER_OPTS, ls_step_clip=0.2)
    res, ref, s = _solve_both(CHATTER, 16, 0.05, "S", opts)
    _assert_matches(res, ref, 1e-8)
    plant, cost, _, _ = _arm2()
    unclipped = make_sqp(plant, cost, s.cset, 16, 0.05, method="S",
                         options=SQPOptions(**CHATTER_OPTS))
    zeros = lambda B: (torch.zeros((B, 4, 16), dtype=f64),
                       torch.zeros((B, 2, 15), dtype=f64))
    params = lambda g: cost.default_params._replace(xg=torch.tensor(g))
    r0 = unclipped.solve(*zeros(3), params(GOALS))
    assert (r0.U - res.U).abs().max() > 1e-3
    alone = s.solve(*zeros(1), params(GOALS[:1]))
    assert int(alone.sqp_iters[0]) == int(res.sqp_iters[0])
    assert (alone.U[0] - res.U[0]).abs().max() < 1e-12


def test_hard_violation_exit_tol_matches_jax():
    """Repaired fault: the port accepted hard_violation_exit_tol and never
    read it.  On the chatter configuration the ungated solve exits
    'converged' with the bound violated (> 0.6 on goal 0); gated, the port
    takes JAX's exits and iterates."""
    opts = dict(CHATTER_OPTS, hard_violation_exit_tol=1e-3)
    res, ref, s = _solve_both(CHATTER, 16, 0.05, "S", opts, goals=GOALS[:1])
    _assert_matches(res, ref, 1e-8)
    plant, cost, _, _ = _arm2()
    ungated = make_sqp(plant, cost, s.cset, 16, 0.05, method="S",
                       options=SQPOptions(**CHATTER_OPTS))
    r0 = ungated.solve(torch.zeros((1, 4, 16), dtype=f64),
                       torch.zeros((1, 2, 15), dtype=f64))
    assert int(r0.exit_sqp[0]) == 1 and float(r0.U.abs().max()) > 0.6
    gated_ok = (int(res.exit_sqp[0]) != 1
                or float(TC.max_hard_violation(s.cset, res.X, res.U)[0]) <= 1e-3)
    assert gated_ok
    assert (int(res.sqp_iters[0]), int(res.exit_sqp[0])) != (
        int(r0.sqp_iters[0]), int(r0.exit_sqp[0]))


def test_soft_outer_loop_freezes_finished_scenarios():
    """Repaired fault: the soft state moved for every scenario every outer
    round.  Goal 2 converges in its first round with a violation under
    exit_tolerance_soft (0.02) but above 0, so its state must stay the
    fresh one: untouched on the round it exits, and frozen while goal 1
    runs more rounds.  Solved alone it equals itself in the batch, and
    both equal JAX."""
    opts = dict(expected_reduction_min=-100.0, exit_tolerance_soft=0.02)
    build = lambda cs: cs.with_joint_limits(1.1, -1.1, "AUGMENTED_LAGRANGIAN")
    res, ref, s = _solve_both(build, 10, 0.1, "S", opts)
    _assert_matches(res, ref, 1e-8)
    for a, b in zip(res.cstate[0], ref.cstate[0]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9, atol=1e-9)
    assert res.outer_iters.tolist()[2] == 0 and res.outer_iters.tolist()[1] > 2
    viol = TC.max_soft_violation(s.cset, res.cstate, res.X, res.U)
    assert 0.0 < float(viol[2]) < 0.02
    fresh = s.cset.init_state(f64, "cpu")[0]
    for a, b in zip(res.cstate[0], fresh):
        assert torch.equal(a[2], b)
    plant, cost, _, _ = _arm2()
    alone = s.solve(torch.zeros((1, 4, 10), dtype=f64),
                    torch.zeros((1, 2, 9), dtype=f64),
                    cost.default_params._replace(xg=torch.tensor(GOALS[2:])))
    for a, b in zip(alone.cstate[0], res.cstate[0]):
        assert torch.equal(a[0], b[2])
    assert (alone.U[0] - res.U[2]).abs().max() < 1e-12


def test_watchdog_resets_the_soft_state():
    """Repaired fault: the MPC watchdog cold-reset the plan and the
    multipliers but kept the soft state.  With an actuation bound no
    solve meets, every step's carry is reset, so the last soft state is
    the fresh one; without the watchdog the AL rounds move it."""
    knobs = dict(F.AL_KNOBS, torque_limit=2.0, max_iter_soft=3)
    _, cost, solver = F.flagship(N=8, dtype=f64, device="cpu", **knobs)
    x0s, goals = F.bench_scenarios(2)
    params = cost.default_params._replace(xg=torch.tensor(goals))
    fresh = solver.cset.init_state(f64, "cpu", batch=(2,))
    runs = {}
    for u_max in (1e-9, float("inf")):
        ctrl = MPCController(solver=solver, sim_plant=solver.plant,
                             watchdog_u_max=u_max)
        runs[u_max] = ctrl.run(torch.tensor(x0s), 2, cost_params=params)
    moved = any(not torch.equal(a, b) for st, fr in
                zip(runs[float("inf")].cstate_last, fresh)
                for a, b in zip(st, fr))
    assert moved
    for st, fr in zip(runs[1e-9].cstate_last, fresh):
        for a, b in zip(st, fr):
            assert torch.equal(a, b)


@pytest.mark.parametrize("option", [dict(ls_fixed_alpha=0.5),
                                    dict(rti_lean=True),
                                    dict(rti_step_clip=1.0)])
def test_only_the_rti_options_raise(option):
    """The RTI options once raised here (the name is kept).  Each RTI
    option builds a solver (beside ls_step_clip and
    hard_violation_exit_tol).  ls_fixed_alpha replaces the line search;
    rti_lean and rti_step_clip without it are ignored, as in JAX
    (sqp.py:402, :542): the solve equals the default one bit for bit."""
    plant, cost, _, _ = _arm2()
    make_sqp(plant, cost, None, 10, 0.1, method="S",
             options=SQPOptions(ls_step_clip=0.5, hard_violation_exit_tol=1e-3))
    zeros = (torch.zeros((1, 4, 10), dtype=f64),
             torch.zeros((1, 2, 9), dtype=f64))
    base = dict(expected_reduction_min=-100.0, max_iter=6)
    ref = make_sqp(plant, cost, None, 10, 0.1, method="S",
                   options=SQPOptions(**base)).solve(*zeros)
    res = make_sqp(plant, cost, None, 10, 0.1, method="S",
                   options=SQPOptions(**base, **option)).solve(*zeros)
    same = torch.equal(res.U, ref.U) and torch.equal(res.J, ref.J)
    assert same == ("ls_fixed_alpha" not in option)
