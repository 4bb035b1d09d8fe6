"""The port's iLQR solver against the JAX package (f64, CPU).

* ``_cho_guarded`` on PD, non-PD and NaN matrices: the ``ok`` flag and the
  factor (jittered where the first one failed, NaN where the jittered one
  fails too).
* ``backward`` and ``backward_parallel`` against JAX at the same
  expansions, and against each other to 1e-9; the log-depth suffix scan
  against an explicit suffix product at N = 5.
* ``rollout`` with a per-scenario alpha.
* Full solves against JAX ``make_ilqr`` on the same numpy inputs: the
  pendulum (N = 20), cart-pole (N = 50), double integrator (N = 12), arm2
  with ``UrdfCost`` and the soft-constrained (AUGMENTED_LAGRANGIAN)
  pendulum, each with both backward passes: equal exit codes and iteration
  counts, X, U, K and J to 1e-8 relative to each array's largest entry.
  On the soft pendulum the last AL rounds run at penalty weights mu of
  1e2 to 1e5 on the nine knots sitting on the limit; there the soft
  gradient is mu (u - 7) + lambda with |u - 7| ~ 1e-5, so a knot's gains
  and its multiplier update move by mu times the controls' rounding
  difference (X, U and J agree to 2e-10 with the sequential pass, 1e-8
  with the parallel one).  K and the AL multipliers are held per knot to
  1e-8 x max(1, mu_k) of their largest entry.
* Hard constraints raise ValueError, the flagship's hard torque modes too.
* Batch invariance: each scenario of a batch whose scenarios exit at
  different iterations equals, bit for bit, the scenario solved alone.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajoptmpcreference_tpu.models import plants as JP
from trajoptmpcreference_tpu.models.urdf import serial_arm as jax_serial_arm
from trajoptmpcreference_tpu.solvers import constraints as JC
from trajoptmpcreference_tpu.solvers import costs as JCost
from trajoptmpcreference_tpu.solvers.ilqr import _cho_guarded as jax_cho_guarded
from trajoptmpcreference_tpu.solvers.ilqr import make_ilqr as jax_make_ilqr
from trajoptmpcreference_tpu.solvers.sqp import SQPOptions as JaxOptions
from trajoptmpcreference_tpu_torch import convert
from trajoptmpcreference_tpu_torch import flagship as F
from trajoptmpcreference_tpu_torch.models import plants as TP
from trajoptmpcreference_tpu_torch.solvers import costs as TCost
from trajoptmpcreference_tpu_torch.solvers.constraints import ConstraintSet
from trajoptmpcreference_tpu_torch.solvers.ilqr import ILQRSolver, _cho_guarded, make_ilqr

jax.config.update("jax_enable_x64", True)

f64 = torch.float64
REL = 1e-8


def t(a):
    return torch.tensor(np.asarray(a), dtype=f64)


def rel(out, ref):
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return float(np.abs(out.numpy() - ref).max() / max(np.abs(ref).max(), 1e-300))


# ------------------------------------------------------------ problems

def _quadratic(plant_name, Q, QF, R, xg, N, dt, u0, options=None, soft=None):
    jp, tp = getattr(JP, plant_name)(), getattr(TP, plant_name)()
    jc = JCost.QuadraticCost(Q, QF, R, xg)
    tc = TCost.QuadraticCost(t(Q), t(QF), t(R), t(xg))
    jset = None
    if soft is not None:
        jset = JC.ConstraintSet(jp.nq, jp.nv, jp.nu, N).with_torque_limits(
            soft, -soft, "AUGMENTED_LAGRANGIAN")
    return dict(jp=jp, tp=tp, jc=jc, tc=tc, jset=jset, N=N, dt=dt,
                x0=np.zeros((jp.nx, N)), u0=u0 * np.ones((jp.nu, N - 1)),
                options=options)


def problem(name):
    """The JAX package's own iLQR problems (tests/test_ilqr.py)."""
    if name == "pendulum":
        return _quadratic("PendulumPlant", np.eye(2), 100.0 * np.eye(2),
                          0.1 * np.eye(1), np.array([np.pi, 0.0]), 20, 0.1, 0.0)
    if name == "cartpole":
        return _quadratic("CartPolePlant", np.diag([0.1, 1.0, 0.1, 0.1]),
                          100.0 * np.eye(4), 0.01 * np.eye(1),
                          np.array([0.0, np.pi, 0.0, 0.0]), 50, 0.05, 0.01)
    if name == "double_integrator":
        return _quadratic("DoubleIntegratorPlant", np.eye(2), 10.0 * np.eye(2),
                          0.1 * np.eye(1), np.array([1.0, 0.0]), 12, 0.1, 0.0,
                          options=JaxOptions(rho_init=1e-10, rho_min=1e-10))
    if name == "soft_pendulum":
        return _quadratic("PendulumPlant", np.eye(2), 100.0 * np.eye(2),
                          0.1 * np.eye(1), np.array([np.pi, 0.0]), 20, 0.1, 0.0,
                          soft=7.0)
    assert name == "arm2"
    robot = jax_serial_arm(2)
    jp = JP.URDFPlant(robot=robot)
    tp = TP.URDFPlant(robot=convert.robot_from_numpy(robot))
    a = (np.eye(4), 100.0 * np.eye(4), 0.1 * np.eye(2),
         np.array([0.5, 1.5, 0.0, 0.0]))
    return dict(jp=jp, tp=tp, jc=JCost.UrdfCost(jp, *a),
                tc=TCost.UrdfCost(tp, *map(t, a)), jset=None, N=10, dt=0.1,
                x0=np.zeros((4, 10)), u0=np.zeros((2, 9)),
                options=JaxOptions(expected_reduction_min=-100.0))


def solvers(p, parallel=False):
    tset = None if p["jset"] is None else convert.constraint_set_from_numpy(p["jset"])
    o = p["options"]
    topts = None if o is None else convert.options_from_dict(dataclasses.asdict(o))
    return (jax_make_ilqr(p["jp"], p["jc"], p["jset"], p["N"], p["dt"],
                          options=o, parallel_riccati=parallel),
            make_ilqr(p["tp"], p["tc"], tset, p["N"], p["dt"], options=topts,
                      parallel_riccati=parallel))


# ----------------------------------------------------------- _cho_guarded

@pytest.mark.parametrize("kind", ["pd", "indefinite", "nan"])
def test_cho_guarded_matches_jax(kind):
    M = {"pd": [[4.0, 1.0, 0.5], [1.0, 3.0, 0.2], [0.5, 0.2, 2.0]],
         "indefinite": [[1.0, 0.0, 0.0], [0.0, -1e-4, 0.0], [0.0, 0.0, 2.0]],
         "nan": [[1.0, np.nan, 0.0], [np.nan, 2.0, 0.0], [0.0, 0.0, 1.0]]}[kind]
    M = np.asarray(M)
    rho = 1e-3
    (Lj, _), okj = jax_cho_guarded(jnp.asarray(M), jnp.asarray(rho))
    L, ok = _cho_guarded(t(M)[None], t(rho)[None])
    assert bool(ok[0]) == bool(okj) == (kind == "pd")
    Lj = np.tril(np.asarray(Lj))
    if kind == "nan":
        # JAX keeps NaN where the jittered factor fails as well
        assert np.isnan(Lj).any() and bool(L.isnan().any())
        return
    np.testing.assert_allclose(torch.tril(L[0]).numpy(), Lj, rtol=0, atol=1e-14)
    assert bool(torch.isfinite(L).all())


# ----------------------------------------------------- backward passes

def _expansions(seed=0, B=3):
    p = problem("pendulum")
    p["jc"] = JCost.QuadraticCost(np.diag([1.0, 0.1]), 100.0 * np.eye(2),
                                  0.01 * np.eye(1), np.array([np.pi, 0.0]))
    p["tc"] = TCost.QuadraticCost(t(np.diag([1.0, 0.1])), t(100.0 * np.eye(2)),
                                  t(0.01 * np.eye(1)), t([np.pi, 0.0]))
    js, ts = solvers(p)
    rng = np.random.default_rng(seed)
    X = 0.3 * rng.standard_normal((B, 2, p["N"]))
    U = 0.3 * rng.standard_normal((B, 1, p["N"] - 1))
    cs = js.cset.init_state(dtype=jnp.float64)
    jex = jax.vmap(lambda X, U: js._expansions(X, U, p["jc"].default_params, cs))(X, U)
    tex = ts._expansions(t(X), t(U), p["tc"].default_params, ())
    return js, ts, jex, tex


def test_backward_passes_match_jax_and_each_other():
    js, ts, jex, tex = _expansions()
    for a, b in zip(jex, tex):
        assert rel(b, a) < 1e-14
    for rho in (1e-3, 1.0):
        rj = jnp.asarray(rho)
        rt = torch.full((3,), rho, dtype=f64)
        seq_j = jax.vmap(lambda *a: js.backward(*a, rj))(*jex)
        par_j = jax.vmap(lambda *a: js.backward_parallel(*a, rj))(*jex)
        seq = ts.backward(*tex, rt)
        par = ts.backward_parallel(*tex, rt)
        for name, a, b, c, d in zip(("K", "kff", "dv1", "dv2"), seq_j, par_j,
                                    seq, par):
            assert rel(c, a) < 1e-12, (name, rho)
            assert rel(d, b) < 1e-12, (name, rho)
            assert rel(d, c.numpy()) < 1e-9, (name, rho)
        assert not bool(seq[4].any()) and not bool(par[4].any())
        np.testing.assert_array_equal(par[4].numpy(), np.asarray(par_j[4]))


def test_suffix_scan_is_the_suffix_product():
    """At N = 5: element k of the log-depth scan equals the explicit
    suffix product e_k . (e_{k+1} . (... . e_4)), earlier element first,
    and the left-nested product too (associativity)."""
    rng = np.random.default_rng(3)
    B, n, nx = 2, 5, 3

    def spd():
        M = rng.standard_normal((B, n, nx, nx))
        return t(M @ M.transpose(0, 1, 3, 2) / nx + 0.1 * np.eye(nx))

    elems = [t(0.5 * rng.standard_normal((B, n, nx, nx))),
             t(rng.standard_normal((B, n, nx))), spd(),
             t(rng.standard_normal((B, n, nx))), spd()]
    out = ILQRSolver._suffix_scan(elems)
    at = lambda k: [e[:, k] for e in elems]
    for k in range(n):
        right = at(n - 1)
        for j in range(n - 2, k - 1, -1):
            right = ILQRSolver._combine(at(j), right)
        left = at(k)
        for j in range(k + 1, n):
            left = ILQRSolver._combine(left, at(j))
        for o, r, l in zip(out, right, left):
            torch.testing.assert_close(o[:, k], r, rtol=1e-11, atol=1e-12)
            torch.testing.assert_close(o[:, k], l, rtol=1e-11, atol=1e-12)


def test_rollout_matches_jax():
    js, ts, jex, tex = _expansions(seed=4)
    rng = np.random.default_rng(5)
    X = 0.3 * rng.standard_normal((3, 2, 20))
    U = 0.3 * rng.standard_normal((3, 1, 19))
    K = rng.standard_normal((3, 19, 1, 2))
    kff = rng.standard_normal((3, 19, 1))
    alpha = np.array([1.0, 0.5, 0.125])
    Xj, Uj = jax.vmap(js.rollout)(X, U, K, kff, alpha)
    Xt, Ut = ts.rollout(*map(t, (X, U, K, kff, alpha)))
    assert rel(Xt, Xj) < 1e-13 and rel(Ut, Uj) < 1e-13


# ----------------------------------------------------------- full solves

@pytest.mark.parametrize("parallel", [False, True])
@pytest.mark.parametrize("name", ["pendulum", "cartpole", "double_integrator",
                                  "arm2", "soft_pendulum"])
def test_solve_matches_jax(name, parallel):
    p = problem(name)
    js, ts = solvers(p, parallel)
    ref = jax.jit(js.solve)(p["x0"], p["u0"])
    res = ts.solve(t(p["x0"])[None], t(p["u0"])[None])
    for field in ("exit_ilqr", "iters", "exit_soft", "outer_iters"):
        assert int(getattr(res, field)[0]) == int(getattr(ref, field)), field
    assert int(ref.exit_ilqr) == (2 if name == "soft_pendulum" else 1)
    for field in ("X", "U", "J"):
        assert rel(getattr(res, field)[0], getattr(ref, field)) < REL, field
    K, Kj = res.K[0].numpy(), np.asarray(ref.K)
    dK = np.abs(K - Kj).max((1, 2)) / np.abs(Kj).max()
    if name == "soft_pendulum":
        mu = np.asarray(ref.cstate[0].mu).max(0)      # per knot, final state
        np.testing.assert_array_equal(res.cstate[0].mu[0].numpy(),
                                      np.asarray(ref.cstate[0].mu))
        lam, lamj = res.cstate[0].lam[0].numpy(), np.asarray(ref.cstate[0].lam)
        dlam = np.abs(lam - lamj).max(0) / np.abs(lamj).max()
        bar = REL * np.maximum(mu, 1.0)
        assert (mu > 1.0).sum() <= 9
        assert (dK < bar).all(), (dK, mu)
        assert (dlam < bar).all(), (dlam, mu)
        assert float(res.U.abs().max()) < 7.0 + 1e-2
    else:
        assert dK.max() < REL, dK


def test_hard_constraints_raise():
    p = problem("pendulum")
    cset = ConstraintSet(1, 1, 1, p["N"]).with_torque_limits(7.0, -7.0,
                                                             "ACTIVE_SET")
    solver = make_ilqr(p["tp"], p["tc"], cset, p["N"], p["dt"])
    with pytest.raises(ValueError, match="soft"):
        solver.solve(t(p["x0"])[None], t(p["u0"])[None])
    for mode in ("ACTIVE_SET", "FULL_SET"):
        with pytest.raises(ValueError, match="soft torque limits only"):
            F.flagship(N=8, dtype=f64, device="cpu", torque_limit=6.0,
                       torque_mode=mode, **F.ILQR_KNOBS)


@pytest.mark.parametrize("parallel", [False, True])
def test_batch_invariance_bit_for_bit(parallel):
    """Four goals whose solves exit at different iterations: each scenario
    of the batch equals the scenario solved alone, bit for bit."""
    p = problem("pendulum")
    _, ts = solvers(p, parallel)
    goals = t([[2.5, 0.0], [3.0, 0.0], [np.pi, 0.0], [1.0, 0.0]])
    params = ts.cost.default_params._replace(xg=goals)
    x0 = torch.zeros((4, 2, 20), dtype=f64)
    u0 = torch.zeros((4, 1, 19), dtype=f64)
    batch = ts.solve(x0, u0, params)
    assert len(set(batch.iters.tolist())) > 1
    for i in range(4):
        alone = ts.solve(x0[i:i + 1], u0[i:i + 1], params._replace(xg=goals[i:i + 1]))
        for field in ("X", "U", "K", "J", "iters", "exit_ilqr"):
            assert torch.equal(getattr(alone, field)[0],
                               getattr(batch, field)[i]), (i, field)
