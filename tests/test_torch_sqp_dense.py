"""The port's dense KKT solve (SQP method "N", MPC "QP-N") against the JAX
package and the reference's golden run (f64, CPU).

* ``KKTSystem.solve_dense`` on the same random blocks as JAX's, without
  and with ACTIVE_SET hard rows: the assembled matrix entry by entry
  (JAX's own, caught at its ``jnp.linalg.solve``), dxu and lam to 1e-10.
* A planted singular scenario (a live hard row whose jacobian is zero: a
  zero row and column of the KKT matrix): ``bad`` in that scenario alone,
  its solution JAX's ``_lstsq`` to 1e-8, the others as without it.
* tests/golden/arm2_N.npz: equal exit codes and controls to 1e-9
  (tests/test_sqp_parity.py:74-83); method "N" against "S" on arm2 to
  1e-9; ``make_sqp`` without a method builds "N".
* tests/test_baseline_configs.py:39-87: the double integrator with a hard
  ACTIVE_SET force limit by method "N" under that test's assertions, and
  the cart-pole with one by method "S", each against JAX to 1e-9.
* MPC "QP-N" on the pendulum against JAX ``make_mpc(..., "QP-N")`` over
  20 steps, to 1e-8.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajoptmpcreference_tpu import (
    CartPolePlant as JCartPole,
    ConstraintSet as JConstraintSet,
    DoubleIntegratorPlant as JDoubleIntegrator,
    PendulumPlant as JPendulum,
    QuadraticCost as JQuadraticCost,
    SQPOptions as JSQPOptions,
    make_mpc as jmake_mpc,
    make_sqp as jmake_sqp,
)
from trajoptmpcreference_tpu.solvers import kkt as JK
from trajoptmpcreference_tpu_torch import (
    CartPolePlant,
    DoubleIntegratorPlant,
    PendulumPlant,
    QuadraticCost,
    SQPOptions,
    URDFPlant,
    UrdfCost,
    make_mpc,
    make_sqp,
    serial_arm,
)
from trajoptmpcreference_tpu_torch import convert
from trajoptmpcreference_tpu_torch.solvers.kkt import KKTBlocks

jax.config.update("jax_enable_x64", True)

GOLDEN = pathlib.Path(__file__).parent / "golden"
f64 = torch.float64


def t(a):
    return torch.tensor(np.asarray(a), dtype=f64)


def rel(out, ref):
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return float(np.abs(out.numpy() - ref).max() / max(np.abs(ref).max(), 1e-300))


# ------------------------------------------------------------ solve_dense

def _random_blocks(rng, N, nx, nu, m, B):
    """B scenarios of well-conditioned KKT blocks (numpy, batch first)."""
    n = nx + nu
    M = rng.standard_normal((B, N, n, n))
    H = M @ M.transpose(0, 1, 3, 2) / n + np.eye(n)
    return dict(H=H, g=rng.standard_normal((B, N, n)),
                A=np.eye(nx) + 0.1 * rng.standard_normal((B, N - 1, nx, nx)),
                B=0.1 * rng.standard_normal((B, N - 1, nx, nu)),
                defect=rng.standard_normal((B, N, nx)),
                hval=rng.standard_normal((B, N, m)),
                hjac=rng.standard_normal((B, N, m, n)),
                # at most one live hard row a knot: with the nx defect rows
                # that keeps the live rows independent
                hact=(rng.random((B, N, m)) < 0.6) & (np.arange(m) == 0))


def _jax_dense(jkkt, blocks, rho, monkeypatch):
    """JAX's solve_dense of scenario by scenario, and the KKT matrix and
    right-hand side it assembled (caught at its first jnp.linalg.solve)."""
    solve = jnp.linalg.solve
    out = []
    for i in range(len(rho)):
        caught = []

        def catch(A, b):
            caught.append((A, b))
            return solve(A, b)

        monkeypatch.setattr(jnp.linalg, "solve", catch)
        jb = JK.KKTBlocks(**{k: jnp.asarray(v[i]) for k, v in blocks.items()})
        dxu, lam, bad = jkkt.solve_dense(jb, jnp.asarray(rho[i]))
        monkeypatch.setattr(jnp.linalg, "solve", solve)
        out.append((np.asarray(dxu), np.asarray(lam), bool(bad),
                    np.asarray(caught[0][0]), np.asarray(caught[0][1])))
    return [np.stack([o[j] for o in out]) for j in range(5)]


def _kkt_pair(limits):
    """(JAX KKTSystem, port KKTSystem) of the double integrator at N = 5,
    with ACTIVE_SET force limits (m = 2 hard rows a knot) or without."""
    N = 5
    jcs = JConstraintSet(1, 1, 1, N)
    if limits:
        jcs = jcs.with_torque_limits([1.0], [-1.0], "ACTIVE_SET")
    jcost = JQuadraticCost(np.eye(2), np.eye(2), np.eye(1), np.zeros(2))
    cost = QuadraticCost(t(np.eye(2)), t(np.eye(2)), t(np.eye(1)), t(np.zeros(2)))
    jk = jmake_sqp(JDoubleIntegrator(), jcost, jcs, N, 0.1, method="N").kkt
    tk = make_sqp(DoubleIntegratorPlant(), cost,
                  convert.constraint_set_from_numpy(jcs), N, 0.1,
                  method="N").kkt
    assert tk.m == jk.m == 2 * limits
    return jk, tk


@pytest.mark.parametrize("limits", [False, True], ids=["free", "active_set"])
def test_solve_dense_matches_jax(limits, monkeypatch):
    jk, tk = _kkt_pair(limits)
    rng = np.random.default_rng(4 + limits)
    blocks = _random_blocks(rng, tk.N, tk.nx, tk.nu, tk.m, 3)
    rho = np.array([1e-3, 0.1, 1.0])
    dxu_j, lam_j, bad_j, K_j, b_j = _jax_dense(jk, blocks, rho, monkeypatch)
    tb = KKTBlocks(**{k: torch.tensor(v) for k, v in blocks.items()})
    K, b = tk.dense_kkt(tb, t(rho))
    np.testing.assert_array_equal(K.numpy(), K_j)
    np.testing.assert_array_equal(b.numpy(), b_j)
    dxu, lam, bad = tk.solve_dense(tb, t(rho))
    assert not bad.any() and not bad_j.any()
    assert rel(dxu, dxu_j) < 1e-10 and rel(lam, lam_j) < 1e-10
    if limits:
        assert 0 < blocks["hact"].sum() < blocks["hact"].size


def test_singular_scenario_falls_back_alone(monkeypatch):
    jk, tk = _kkt_pair(True)
    rng = np.random.default_rng(9)
    blocks = _random_blocks(rng, tk.N, tk.nx, tk.nu, tk.m, 3)
    blocks["hact"][:] = False
    tb = KKTBlocks(**{k: torch.tensor(v) for k, v in blocks.items()})
    rho = np.full(3, 0.5)
    clean = tk.solve_dense(tb, t(rho))
    # scenario 1: a live hard row with a zero jacobian
    blocks["hact"][1, 2, 0] = True
    blocks["hjac"][1, 2, 0] = 0.0
    dxu_j, lam_j, bad_j, K_j, _ = _jax_dense(jk, blocks, rho, monkeypatch)
    tb = KKTBlocks(**{k: torch.tensor(v) for k, v in blocks.items()})
    dxu, lam, bad = tk.solve_dense(tb, t(rho))
    assert bad.tolist() == [False, True, False] == bad_j.tolist()
    assert not K_j[1, tk.N * tk.n + 2 * tk.bs + tk.nx].any()   # the zero row
    assert rel(dxu[1], dxu_j[1]) < 1e-8 and rel(lam[1], lam_j[1]) < 1e-8
    for i in (0, 2):
        assert torch.equal(dxu[i], clean[0][i]) and torch.equal(lam[i], clean[1][i])


# ------------------------------------------------------------- arm2 goldens

def _arm2(method=None, **kw):
    plant = URDFPlant(robot=serial_arm(2))
    cost = UrdfCost(plant, torch.eye(4, dtype=f64), 100.0 * torch.eye(4, dtype=f64),
                    0.1 * torch.eye(2, dtype=f64), t([0.5, 1.5, 0.0, 0.0]),
                    ref_compat=True)
    opts = SQPOptions(expected_reduction_min=-100.0)
    if method is None:
        return make_sqp(plant, cost, None, 10, 0.1, options=opts, **kw)
    return make_sqp(plant, cost, None, 10, 0.1, method=method, options=opts, **kw)


def test_arm2_N_matches_golden_and_method_S():
    gold = np.load(GOLDEN / "arm2_N.npz")
    zeros = (torch.zeros((1, 4, 10), dtype=f64), torch.zeros((1, 2, 9), dtype=f64))
    default = _arm2()
    assert default.method == "N"                   # JAX's default method
    res = default.solve(*zeros)
    assert int(res.exit_sqp[0]) == int(gold["exit_sqp"])
    assert int(res.exit_soft[0]) == int(gold["exit_soft"])
    assert np.abs(res.U[0].numpy() - gold["u"]).max() < 1e-9
    assert np.abs(res.X[0].numpy() - gold["x"]).max() < 1e-9
    s = _arm2("S").solve(*zeros)
    assert torch.equal(s.sqp_iters, res.sqp_iters)
    assert float((s.U - res.U).abs().max()) < 1e-9


# -------------------------------------------------- baseline configurations

def _solve_both(jplant, plant, Q, QF, R, xg, limit, N, dt, method, opts, X0):
    jcs = JConstraintSet(plant.nq, plant.nv, plant.nu, N).with_torque_limits(
        [limit], [-limit], "ACTIVE_SET", activation_band=0.1)
    cs = convert.constraint_set_from_numpy(jcs)
    js = jmake_sqp(jplant, JQuadraticCost(Q, QF, R, xg), jcs, N, dt,
                   method=method, options=JSQPOptions(**opts))
    s = make_sqp(plant, QuadraticCost(t(Q), t(QF), t(R), t(xg)), cs, N, dt,
                 method=method, options=SQPOptions(**opts))
    ref = jax.jit(js.solve)(jnp.asarray(X0), jnp.zeros((plant.nu, N - 1)))
    res = s.solve(t(X0)[None], torch.zeros((1, plant.nu, N - 1), dtype=f64))
    for field in ("exit_sqp", "sqp_iters"):
        assert int(getattr(res, field)[0]) == int(getattr(ref, field)), field
    assert rel(res.U[0], ref.U) < 1e-9 and rel(res.X[0], ref.X) < 1e-9
    return res


def test_double_integrator_method_N_active_set():
    """tests/test_baseline_configs.py:39-66 in the port, and against JAX."""
    N = 24
    res = _solve_both(JDoubleIntegrator(), DoubleIntegratorPlant(),
                      np.diag([10.0, 1.0]), 100.0 * np.eye(2), 0.02 * np.eye(1),
                      np.array([1.0, 0.0]), 2.0, N, 0.1, "N",
                      dict(expected_reduction_min=-100.0,
                           hard_violation_exit_tol=0.02, max_iter=60),
                      np.zeros((2, N)))
    assert int(res.exit_sqp[0]) in (1, 3)
    assert float(res.U.abs().max()) <= 2.0 * 1.02
    assert abs(float(res.X[0, 0, -1]) - 1.0) < 0.05
    assert float(res.U.abs().max()) > 1.9            # the limit binds


def test_cartpole_method_S_active_set():
    """tests/test_baseline_configs.py:69-87 in the port, and against JAX."""
    N = 30
    X0 = np.zeros((4, N))
    X0[1] = 0.5                                      # 0.5 rad tilt
    res = _solve_both(JCartPole(), CartPolePlant(),
                      np.diag([1.0, 10.0, 0.1, 1.0]), 100.0 * np.eye(4),
                      0.05 * np.eye(1), np.zeros(4), 8.0, N, 0.05, "S",
                      dict(expected_reduction_min=-100.0), X0)
    assert int(res.exit_sqp[0]) in (1, 3)
    assert float(res.U.abs().max()) <= 8.0 + 1e-3
    assert abs(float(res.X[0, 1, -1])) < 0.1


# ------------------------------------------------------------------ QP-N MPC

def test_mpc_qp_n_pendulum_matches_jax():
    Q, QF, R, XG = np.eye(2), 100.0 * np.eye(2), 0.1 * np.eye(1), np.array([np.pi, 0.0])
    jctrl = jmake_mpc(JPendulum(), JQuadraticCost(Q, QF, R, XG), None, 20, 0.1,
                      method="QP-N")
    ctrl = make_mpc(PendulumPlant(), QuadraticCost(t(Q), t(QF), t(R), t(XG)),
                    None, 20, 0.1, method="QP-N")
    assert ctrl.solver.method == "N"
    ref = jax.jit(lambda x: jctrl.run(x, steps=20))(jnp.zeros(2))
    res = ctrl.run(torch.zeros((1, 2), dtype=f64), 20)
    np.testing.assert_array_equal(res.iters[0].numpy(), np.asarray(ref.iters))
    np.testing.assert_array_equal(res.exit_codes[0].numpy(),
                                  np.asarray(ref.exit_codes))
    for field in ("X_applied", "U_applied", "J_solve", "X_plan_last",
                  "U_plan_last", "lam_last"):
        assert rel(getattr(res, field)[0], getattr(ref, field)) < 1e-8, field
