"""The port's MPC loop with method "iLQR" and the iLQR plan reset against
the JAX package (f64, CPU).

* MPC "iLQR" on the pendulum (tests/test_mpc.py:29-34's setup: N = 20,
  dt = 0.1, 50 steps from rest) against JAX ``make_mpc(..., "iLQR")``:
  applied states and controls, solve costs to 1e-8, equal iteration counts
  and exit codes; "QP-N" builds a dense-KKT SQP controller.
* The warm-rollout plan reset, per scenario: a batch in which one
  scenario's warm controls overflow the rollout restarts that scenario
  from zero controls, equal to JAX on the same inputs, while its
  batchmates solve as they would alone.
* tests/test_ilqr.py:232's case on the port in f64: the 6-DoF flagship at
  N = 16, 8 iLQR iterations a step, 30 closed-loop steps, stays finite
  and bounded.  The loop is chaotic: in f64 the port and JAX agree to
  8.5e-11 after one step and the gap grows ~10x a step; in f32 rounding
  alone moves the first step by ~1e-3, and the port's f32 run reaches a
  state whose Quu is indefinite beyond the jitter (an eigenvalue of -111
  against a jitter of 0.03), where the backward pass is NaN by the JAX
  definition, every solve ends at RHO_MAX and the arm runs away.  Which
  f32 run meets such a state is set by rounding, so the f32 case is not a
  test of the port (ROADMAP.md queue 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from trajoptmpcreference_tpu import PendulumPlant as JaxPendulum
from trajoptmpcreference_tpu import QuadraticCost as JaxQuadraticCost
from trajoptmpcreference_tpu import make_mpc as jax_make_mpc
from trajoptmpcreference_tpu.solvers.ilqr import make_ilqr as jax_make_ilqr
from trajoptmpcreference_tpu_torch import PendulumPlant, QuadraticCost, make_mpc
from trajoptmpcreference_tpu_torch import flagship as F
from trajoptmpcreference_tpu_torch.solvers.ilqr import make_ilqr
from trajoptmpcreference_tpu_torch.solvers.mpc import MPCController

jax.config.update("jax_enable_x64", True)

f64 = torch.float64
Q, QF, R, XG = np.eye(2), 100.0 * np.eye(2), 0.1 * np.eye(1), np.array([np.pi, 0.0])


def t(a):
    return torch.tensor(np.asarray(a), dtype=f64)


def rel(out, ref):
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return float(np.abs(out.numpy() - ref).max() / max(np.abs(ref).max(), 1e-300))


def test_mpc_ilqr_pendulum_matches_jax():
    jctrl = jax_make_mpc(JaxPendulum(), JaxQuadraticCost(Q, QF, R, XG), None,
                         20, 0.1, method="iLQR")
    ctrl = make_mpc(PendulumPlant(), QuadraticCost(t(Q), t(QF), t(R), t(XG)),
                    None, 20, 0.1, method="iLQR")
    ref = jax.jit(lambda x: jctrl.run(x, steps=50))(jnp.zeros(2))
    res = ctrl.run(torch.zeros((1, 2), dtype=f64), 50)
    np.testing.assert_array_equal(res.iters[0].numpy(), np.asarray(ref.iters))
    np.testing.assert_array_equal(res.exit_codes[0].numpy(),
                                  np.asarray(ref.exit_codes))
    for field in ("X_applied", "U_applied", "J_solve", "X_plan_last",
                  "U_plan_last"):
        assert rel(getattr(res, field)[0], getattr(ref, field)) < 1e-8, field
    # no multipliers: the carry passes through, empty
    assert res.lam_last.shape == (1, 0)
    # the swing-up holds at the top (tests/test_mpc.py:37-41)
    assert abs(float(res.X_applied[0, 0, -1]) - np.pi) < 1e-2
    qp_n = make_mpc(PendulumPlant(), QuadraticCost(t(Q), t(QF), t(R), t(XG)),
                    None, 20, 0.1, method="QP-N")
    assert type(qp_n.solver).__name__ == "SQPSolver"
    assert qp_n.solver.method == "N"


def test_plan_reset_is_per_scenario():
    """Scenario 1's warm controls (1e6 N m) carry its rollout past 1e6, so
    its solve restarts from zero controls (ilqr.py:421-433); scenario 0's
    warm start is kept.  Both equal JAX's vmapped solve; each equals the
    scenario solved alone."""
    N = 20
    jsolver = jax_make_ilqr(JaxPendulum(), JaxQuadraticCost(Q, QF, R, XG),
                            None, N, 0.1)
    solver = make_ilqr(PendulumPlant(), QuadraticCost(t(Q), t(QF), t(R), t(XG)),
                       None, N, 0.1)
    x0 = np.zeros((2, 2, N))
    u0 = np.stack([0.5 * np.ones((1, N - 1)), 1e6 * np.ones((1, N - 1))])
    warm = solver._open_loop(t(x0[:, :, 0]), t(u0)).abs().amax((1, 2))
    assert float(warm[0]) < 1e3 and float(warm[1]) > 1e6
    ref = jax.jit(jax.vmap(jsolver.solve))(x0, u0)
    res = solver.solve(t(x0), t(u0))
    for field in ("X", "U", "K", "J"):
        assert rel(getattr(res, field), getattr(ref, field)) < 1e-8, field
    np.testing.assert_array_equal(res.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_array_equal(res.exit_ilqr.numpy(), np.asarray(ref.exit_ilqr))
    zero = solver.solve(t(x0[1:]), torch.zeros((1, 1, N - 1), dtype=f64))
    kept = solver.solve(t(x0[:1]), t(u0[:1]))
    assert torch.equal(res.U[1], zero.U[0]) and torch.equal(res.X[1], zero.X[0])
    assert torch.equal(res.U[0], kept.U[0]) and torch.equal(res.X[0], kept.X[0])


def test_flagship_warm_rollout_stays_finite():
    """tests/test_ilqr.py:232's closed loop on the port in f64 (the CPU's
    plain versions): the shifted single-shooting warm start of the 6-DoF
    arm at N = 16 must not spiral to overflow."""
    dtype = torch.float64
    plant, cost, solver = F.flagship(N=16, max_iter=8, dtype=dtype,
                                     device="cpu", method="iLQR")
    ctrl = MPCController(solver=solver, sim_plant=plant)
    rng = np.random.default_rng(0)
    x0 = torch.as_tensor(0.1 * rng.standard_normal((1, plant.nx)), dtype=dtype)
    goal = torch.as_tensor([[3.0, 2.0, 0, 0, 0, 0]], dtype=dtype)
    res = ctrl.run(x0, 30, cost_params=cost.default_params._replace(xg=goal))
    X = res.X_applied.double()
    assert bool(torch.isfinite(X).all()), dtype
    assert float(X.abs().max()) < 1e4, (dtype, float(X.abs().max()))
