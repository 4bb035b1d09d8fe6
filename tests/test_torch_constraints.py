"""The port's box constraints against the JAX package's, f64 on the CPU.

The JAX functions are written per sample; here they run under
``jax.vmap`` over B = 3 scenarios (and, for the knot functions, over the
knots), and the port's batched functions take the same inputs, drawn from
``np.random.default_rng``, with the batch as the leading axis.  Every
value agrees to 1e-12 (the same arithmetic; only the order of a few sums
differs).  The set is tests/test_constraints.py's: joint ACTIVE_SET,
velocity FULL_SET, torque AUGMENTED_LAGRANGIAN, plus a QUADRATIC_PENALTY
joint limit and ACTIVE_SET rows with an activation band.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajoptmpcreference_tpu.solvers import constraints as JC
from trajoptmpcreference_tpu_torch import convert
from trajoptmpcreference_tpu_torch.solvers import constraints as TC

B, N = 3, 10
NQ = NV = NU = 2
TOL = 1e-12


def _both(build):
    """The same set built in both packages by ``build(ConstraintSet)``."""
    return (build(JC.ConstraintSet(NQ, NV, NU, N)),
            build(TC.ConstraintSet(NQ, NV, NU, N)))


def _reference_set(cs):
    return (cs.with_joint_limits(2.0, -2.0, "ACTIVE_SET")
            .with_velocity_limits(5.0, -5.0, "FULL_SET")
            .with_torque_limits(7.0, -7.0, "AUGMENTED_LAGRANGIAN"))


def _soft_set(cs):
    """Soft limits of both kinds on x and on u (not x/u separable)."""
    return (cs.with_joint_limits([1.0, 1.5], [-1.2, -1.0], "QUADRATIC_PENALTY")
            .with_velocity_limits(2.0, -2.0, "AUGMENTED_LAGRANGIAN")
            .with_torque_limits(1.5, -1.5, "AUGMENTED_LAGRANGIAN", size=1))


def _banded_set(cs):
    return (cs.with_torque_limits(1.0, -1.0, "ACTIVE_SET",
                                  activation_band=0.2)
            .with_joint_limits(1.0, -1.0, "ACTIVE_SET"))


SETS = {"reference": _reference_set, "soft": _soft_set, "banded": _banded_set}


def _close(a, b, tol=TOL):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.dtype == bool:
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol)


def _trajectory(seed):
    """X (B, nx, N), U (B, nu, N-1) straddling every bound of the sets,
    with some values exactly on a bound (where the band matters)."""
    rng = np.random.default_rng(seed)
    X = 2.5 * rng.standard_normal((B, NQ + NV, N))
    U = 3.0 * rng.standard_normal((B, NU, N - 1))
    X[0, 0, 3] = 2.0            # on the joint upper bound
    X[1, 1, 5] = -1.0
    U[2, 0, 4] = 1.0            # on the torque bound (band 0.2 keeps it)
    U[0, 1, 2] = -7.0
    return X, U


def _random_state(jcs, seed):
    """A nonzero soft state (as after outer rounds) for both packages."""
    rng = np.random.default_rng(seed)
    out = []
    for l in jcs.soft_limits:
        shape = (B, l.rows, l.num_timesteps)
        out.append(JC.SoftLimitState(
            mu=jnp.asarray(10.0 ** rng.uniform(-2, 2, shape)),
            lam=jnp.asarray(rng.uniform(0, 3, shape)),
            phi=jnp.asarray(10.0 ** rng.uniform(-3, 0.5, shape))))
    return tuple(out), convert.soft_state_from_numpy(out, device="cpu")


def _leaves(state):
    return [a for st in state for a in st]


def test_mode_validation_matches_jax():
    for pkg in (JC, TC):
        cs = pkg.ConstraintSet(1, 1, 1, 5)
        with pytest.raises(NotImplementedError, match="ADMM"):
            cs.with_torque_limits(1.0, -1.0, "ADMM_PROJECTION")
        with pytest.raises(ValueError, match="Invalid constraint mode"):
            cs.with_joint_limits(1.0, -1.0, "BOGUS")
        with pytest.raises(ValueError, match="constraint size"):
            cs.with_velocity_limits([1.0, 2.0], -1.0, "FULL_SET")


@pytest.mark.parametrize("name", sorted(SETS))
def test_sets_match_jax(name):
    """Every mode builds (no raise), with the JAX set's specs, row counts,
    separability and fresh state; convert.constraint_set_from_numpy gives
    the same set."""
    jcs, tcs = _both(SETS[name])
    assert convert.constraint_set_from_numpy(jcs) == tcs
    for jl, tl in zip(jcs.limits, tcs.limits):
        assert dataclasses.asdict(jl) == dataclasses.asdict(tl)
    for attr in ("hard_rows_stage", "hard_rows_term"):
        assert getattr(jcs, attr) == getattr(tcs, attr)
    for fn in ("has_soft", "has_hard", "soft_xu_separable"):
        assert getattr(jcs, fn)() == getattr(tcs, fn)()
    fresh = tcs.init_state(torch.float64, "cpu", batch=(B,))
    ref = jax.vmap(lambda _: jcs.init_state(jnp.float64))(jnp.arange(B))
    for a, b in zip(_leaves(fresh), _leaves(ref)):
        assert a.dtype == torch.float64 and a.device.type == "cpu"
        _close(a, b)
    f32 = tcs.init_state(torch.float32, "cpu")
    assert all(a.dtype == torch.float32 and a.dim() == 2 for a in _leaves(f32))


@pytest.mark.parametrize("name", sorted(SETS))
def test_primitives_match_jax(name):
    jcs, tcs = _both(SETS[name])
    X, U = _trajectory(1)
    jstate, tstate = _random_state(jcs, 2)
    t = torch.tensor
    Z = np.concatenate([X[:, :, :-1], U], axis=1)          # (B, n, N-1)
    width = NQ + NV + NU
    si = 0
    for jl, tl in zip(jcs.limits, tcs.limits):
        z = Z[:, tl.col_offset:tl.col_offset + tl.size, 4]   # (B, s) at k=4
        _close(TC.margin(tl, t(z)), jax.vmap(lambda v: JC.margin(jl, v))(z))
        _close(TC.signed_selector(tl, width, torch.float64),
               JC.signed_selector(jl, width, jnp.float64))
        # the selector is built once per (spec, width, dtype, device)
        assert (TC.signed_selector(tl, width, torch.float64)
                is TC.signed_selector(tl, width, torch.float64))
        if tl.is_hard:
            ref = jax.vmap(lambda v: JC.hard_rows(jl, v, width))(z)
            for a, b in zip(TC.hard_rows(tl, t(z), width), ref):
                _close(a, b)
            continue
        jst, tst = jstate[si], tstate[si]
        si += 1
        XU = U if tl.kind == "torque" else X
        c0 = 0 if tl.kind == "torque" else tl.col_offset
        zk = XU[:, c0:c0 + tl.size, :tl.num_timesteps]
        zk = np.swapaxes(zk, 1, 2)                          # (B, T, s)
        ks = np.arange(tl.num_timesteps)
        per = lambda f: jax.vmap(lambda st, zz: jax.vmap(
            lambda v, k: f(st, v, k))(zz, ks))(jst, zk)
        _close(TC.soft_value(tl, tst, t(zk), t(ks)),
               per(lambda st, v, k: JC.soft_value(jl, st, v, k)))
        _close(TC.soft_jacobian(tl, tst, t(zk), t(ks), width),
               per(lambda st, v, k: JC.soft_jacobian(jl, st, v, k, width)))
        Zs = np.swapaxes(zk, 1, 2)                          # (B, s, T)
        new, flag = TC.update_soft_state(tl, tst, t(Zs))
        jnew, jflag = jax.vmap(lambda st, zz: JC.update_soft_state(
            jl, st, zz))(jst, Zs)
        for a, b in zip(list(new) + [flag], list(jnew) + [jflag]):
            _close(a, b)
        for shift in (1, 3):
            sh = TC.shift_soft_state(tl, tst, shift)
            jsh = jax.vmap(lambda st: JC.shift_soft_state(jl, st, shift))(jst)
            for a, b in zip(sh, jsh):
                _close(a, b)


def test_active_set_band_is_strict():
    """ACTIVE_SET activates on margin < band: a row exactly on its bound
    is inactive at band 0 and active at band 0.2, as in JAX."""
    for band, want in ((0.0, False), (0.2, True)):
        jcs, tcs = _both(lambda cs: cs.with_torque_limits(
            1.0, -1.0, "ACTIVE_SET", activation_band=band))
        z = np.array([[1.0, 0.0], [0.5, -1.0], [1.1, 0.95]])
        _, _, act = TC.hard_rows(tcs.limits[0], torch.tensor(z), 6)
        _, _, jact = jax.vmap(lambda v: JC.hard_rows(jcs.limits[0], v, 6))(z)
        _close(act, jact)
        assert bool(act[0, 2]) == want          # ub - z = 0 on scenario 0


@pytest.mark.parametrize("name", sorted(SETS))
def test_aggregates_match_jax(name):
    jcs, tcs = _both(SETS[name])
    X, U = _trajectory(3)
    jstate, tstate = _random_state(jcs, 4)
    t = torch.tensor
    Xk = np.swapaxes(X, 1, 2)                               # (B, N, nx)
    Uk = np.swapaxes(U, 1, 2)                               # (B, N-1, nu)
    ks = np.arange(N - 1)
    kN = np.array([N - 1])
    stage = lambda f: jax.vmap(lambda st, xs, us: jax.vmap(
        lambda x, u, k: f(st, x, u, k))(xs, us, ks))(jstate, Xk[:, :-1], Uk)
    term = lambda f: jax.vmap(lambda st, x: f(st, x, N - 1)[None])(
        jstate, Xk[:, -1])
    xs, us, xN = t(Xk[:, :-1]), t(Uk), t(Xk[:, -1:])
    _close(TC.stage_soft_value(tcs, tstate, xs, us, t(ks)) + 0.0 * xs[..., 0],
           stage(lambda st, x, u, k: JC.stage_soft_value(jcs, st, x, u, k)
                 + 0.0 * x[0]))
    _close(TC.term_soft_value(tcs, tstate, xN, t(kN)) + 0.0 * xN[..., 0],
           term(lambda st, x, k: JC.term_soft_value(jcs, st, x, k) + 0.0 * x[0]))
    _close(TC.stage_soft_jacobian(tcs, tstate, xs, us, t(ks)),
           stage(lambda st, x, u, k: JC.stage_soft_jacobian(jcs, st, x, u, k)))
    _close(TC.term_soft_jacobian(tcs, tstate, xN, t(kN)),
           term(lambda st, x, k: JC.term_soft_jacobian(jcs, st, x, k)))
    for a, b in zip(TC.stage_hard_rows(tcs, xs, us, False),
                    stage(lambda st, x, u, k: JC.stage_hard_rows(jcs, x, u, False))):
        _close(a, b)
    jterm = jax.vmap(lambda x: JC.stage_hard_rows(jcs, x, None, True))(
        Xk[:, -1])
    for a, b in zip(TC.stage_hard_rows(tcs, xN, None, True), jterm):
        _close(a[:, 0], b)
    _close(TC.max_soft_violation(tcs, tstate, t(X), t(U)),
           jax.vmap(lambda st, x, u: JC.max_soft_violation(jcs, st, x, u))(
               jstate, X, U))
    _close(TC.max_hard_violation(tcs, t(X), t(U)),
           jax.vmap(lambda x, u: JC.max_hard_violation(jcs, x, u))(X, U))
    new, flag = TC.update_all_soft(tcs, tstate, t(X), t(U))
    jnew, jflag = jax.vmap(lambda st, x, u: JC.update_all_soft(jcs, st, x, u))(
        jstate, X, U)
    assert flag.shape == (B,)
    for a, b in zip(_leaves(new) + [flag], _leaves(jnew) + [jflag]):
        _close(a, b)
    shifted = TC.shift_all_soft(tcs, tstate, 1)
    assert len(shifted) == len(jcs.soft_limits)
    if jstate:
        jshift = jax.vmap(lambda st: JC.shift_all_soft(jcs, st, 1))(jstate)
        for a, b in zip(_leaves(shifted), _leaves(jshift)):
            _close(a, b)


@pytest.mark.parametrize("name", sorted(SETS))
def test_hard_values_match_jax(name):
    """stage_hard_values (the merit's violation term, without the
    jacobian) equals the values of JAX's stage_hard_rows, at the stages
    and at the terminal knot, bit for bit with the port's own."""
    jcs, tcs = _both(SETS[name])
    X, U = _trajectory(5)
    Xk, Uk = np.swapaxes(X, 1, 2), np.swapaxes(U, 1, 2)
    xs, us, xN = (torch.tensor(Xk[:, :-1]), torch.tensor(Uk),
                  torch.tensor(Xk[:, -1:]))
    vals = TC.stage_hard_values(tcs, xs, us, False)
    jvals = jax.vmap(jax.vmap(
        lambda x, u: JC.stage_hard_rows(jcs, x, u, False)[0]))(Xk[:, :-1], Uk)
    _close(vals, jvals)
    assert torch.equal(vals, TC.stage_hard_rows(tcs, xs, us, False)[0])
    term = TC.stage_hard_values(tcs, xN, None, True)
    jterm = jax.vmap(lambda x: JC.stage_hard_rows(jcs, x, None, True)[0])(
        Xk[:, -1])
    _close(term[:, 0], jterm)
    assert torch.equal(term, TC.stage_hard_rows(tcs, xN, None, True)[0])


def test_reductions_are_per_scenario():
    """A violation or an AL update in one scenario leaves its batchmates'
    flags and maxima alone (the JAX functions reduce over one sample)."""
    _, tcs = _both(_soft_set)
    X = torch.zeros((B, 4, N), dtype=torch.float64)
    U = torch.zeros((B, 2, N - 1), dtype=torch.float64)
    X[1, 0, 6] = 3.0                         # only scenario 1 violates
    state = tcs.init_state(torch.float64, "cpu", batch=(B,))
    assert TC.max_soft_violation(tcs, state, X, U).tolist() == [0.0, 2.0, 0.0]
    _, at_max = TC.update_all_soft(tcs, state, X, U)
    assert at_max.tolist() == [True, False, True]
