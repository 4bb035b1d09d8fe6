"""The port's real-time iteration (RTI: ``ls_fixed_alpha``, ``rti_lean``,
``rti_step_clip``) against the JAX package (f64, CPU).

* tests/test_ls_modes.py:86-150 in the port: the RTI closed loop tracks
  like the line-searched one (arm3, N = 12, 120 steps), the carried J
  equals a fresh total_cost, and lean RTI takes exactly the steps of full
  RTI (1e-12) with the carried J left at its 0 placeholder.
* Each RTI mode (fixed alpha, lean, step clip) on the pendulum, three
  goals in one batch (N = 20), against JAX ``make_sqp`` vmapped: states,
  controls and J to 1e-9, equal exit codes and iteration counts.
* The clip is per scenario: in a batch where it binds for two goals (the
  swing-up, a quarter turn) and never for the third (the rest state),
  the latter equals the unclipped solve bit for bit, and each scenario
  solved alone equals its row of the batch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajoptmpcreference_tpu import (
    PendulumPlant as JPendulumPlant,
    QuadraticCost as JQuadraticCost,
    SQPOptions as JSQPOptions,
    make_sqp as jmake_sqp,
)
from trajoptmpcreference_tpu_torch import (
    PendulumPlant,
    QuadraticCost,
    SQPOptions,
    URDFPlant,
    UrdfCost,
    make_sqp,
    serial_arm,
)
from trajoptmpcreference_tpu_torch.solvers.mpc import MPCController

jax.config.update("jax_enable_x64", True)

f64 = torch.float64


def _arm3(N=12, **opts):
    """tests/test_ls_modes.py:33-49's solver in the port."""
    plant = URDFPlant(robot=serial_arm(3), integrator_type=1)
    t = lambda a: torch.tensor(a, dtype=f64)
    cost = UrdfCost(plant, torch.diag(t([1.0, 1.0, 1.0, 0.1, 0.1, 0.1])),
                    100.0 * torch.eye(6, dtype=f64), 0.01 * torch.eye(3, dtype=f64),
                    t([1.5, 1.0, 0.0, 0.0, 0.0, 0.0]))
    base = dict(expected_reduction_min=-100.0, exit_tolerance=1e-8)
    solver = make_sqp(plant, cost, None, N, 0.05, method="S",
                      options=SQPOptions(**{**base, **opts}))
    return (solver, torch.zeros((1, plant.nx, N), dtype=f64),
            torch.zeros((1, plant.nu, N - 1), dtype=f64))


def test_rti_closed_loop_tracks():
    def final_ee(solver):
        ctrl = MPCController(solver=solver, sim_plant=solver.plant)
        res = ctrl.run(torch.zeros((1, 6), dtype=f64), 120)
        q = res.X_applied[:, :3, -1].T.contiguous()
        ee = solver.plant.kinematics.ee_pos_xyz(q)[:2, 0]
        return float(torch.linalg.norm(ee - solver.cost.default_params.xg[:2]))

    err_ref = final_ee(_arm3(max_iter=3)[0])
    err_rti = final_ee(_arm3(max_iter=3, ls_fixed_alpha=1.0)[0])
    assert np.isfinite(err_rti)
    assert err_ref < 0.1, err_ref
    assert err_rti < 0.1, err_rti


def test_rti_carried_totals_consistent():
    rti, x0, u0 = _arm3(max_iter=5, ls_fixed_alpha=1.0)
    res = rti.solve(x0, u0)
    J = float(rti.total_cost(res.X, res.U, rti.cost.default_params, ())[0])
    assert abs(float(res.J[0]) - J) < 1e-8 * max(1.0, abs(J))


def test_rti_lean_matches_full_rti_iterates():
    base = dict(exit_tolerance=0.0, max_iter=4, ls_fixed_alpha=1.0)
    full, x0, u0 = _arm3(N=10, **base)
    lean, _, _ = _arm3(N=10, **base, rti_lean=True)
    rf, rl = full.solve(x0, u0), lean.solve(x0, u0)
    assert float((rl.U - rf.U).abs().max()) <= 1e-12
    assert torch.equal(rl.sqp_iters, rf.sqp_iters)
    assert int(rl.sqp_iters[0]) == 3                  # max_iter - 1, as JAX
    assert float(rl.J[0]) == 0.0 and float(rl.viol[0]) == 0.0


# the pendulum (tests/test_mpc.py:29-34's cost) to three goals: its rest
# state (the clip never binds), the swing-up, and a quarter turn
GOALS = np.array([[0.0, 0.0], [np.pi, 0.0], [1.0, 0.0]])
MODES = {"fixed_alpha": dict(ls_fixed_alpha=1.0),
         "lean": dict(ls_fixed_alpha=1.0, rti_lean=True),
         "clip": dict(ls_fixed_alpha=1.0, rti_step_clip=0.5)}
Q, QF, R = np.eye(2), 100.0 * np.eye(2), 0.1 * np.eye(1)


def _pendulum_pair(N, opts):
    t = lambda a: torch.tensor(a, dtype=f64)
    return (make_sqp(PendulumPlant(), QuadraticCost(t(Q), t(QF), t(R), t(GOALS[1])),
                     None, N, 0.1, method="S", options=SQPOptions(**opts)),
            jmake_sqp(JPendulumPlant(), JQuadraticCost(Q, QF, R, GOALS[1]),
                      None, N, 0.1, method="S", options=JSQPOptions(**opts)))


def _solve(solver, goals, N):
    B = len(goals)
    return solver.solve(torch.zeros((B, 2, N), dtype=f64),
                        torch.zeros((B, 1, N - 1), dtype=f64),
                        solver.cost.default_params._replace(
                            xg=torch.tensor(goals, dtype=f64)))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_rti_mode_matches_jax(mode):
    N = 20
    opts = dict(expected_reduction_min=-100.0, exit_tolerance=1e-8,
                max_iter=6, **MODES[mode])
    solver, jsolver = _pendulum_pair(N, opts)
    B = len(GOALS)
    cps = jax.vmap(lambda g: jsolver.cost.default_params._replace(xg=g))(
        jnp.asarray(GOALS))
    ref = jax.jit(jax.vmap(jsolver.solve))(jnp.zeros((B, 2, N)),
                                           jnp.zeros((B, 1, N - 1)), cps)
    res = _solve(solver, GOALS, N)
    for field in ("exit_sqp", "sqp_iters"):
        np.testing.assert_array_equal(getattr(res, field).numpy(),
                                      np.asarray(getattr(ref, field)), field)
    for field in ("X", "U", "J"):
        r = np.asarray(getattr(ref, field))
        out = getattr(res, field).numpy()
        assert np.abs(out - r).max() <= 1e-9 * max(np.abs(r).max(), 1.0), field
    if mode == "clip":
        # per scenario: the rest goal's steps stay under the clip, so it
        # solves as without it; the far goals are clipped
        free, _ = _pendulum_pair(N, {**opts, "rti_step_clip": float("inf")})
        unclipped = _solve(free, GOALS, N)
        assert torch.equal(unclipped.U[0], res.U[0])
        for i in (1, 2):
            assert float((unclipped.U[i] - res.U[i]).abs().max()) > 1e-3, i
        for i in range(B):
            alone = _solve(solver, GOALS[i:i + 1], N)
            assert torch.equal(alone.sqp_iters[0], res.sqp_iters[i])
            assert float((alone.U[0] - res.U[i]).abs().max()) <= 1e-12
