"""The port's QuadraticCost, ArmCost, NumericalCost and UrdfCost hess_mode
1-3 against the JAX package (arm2, f64, CPU), and total_cost_diff.

Values, gradients and Hessians of the stage (with a QF_start switch inside
the knots) and terminal functions, and the value differences, at seeded
states: to 1e-10 relative to each array's largest entry (NumericalCost's
central differences to 1e-6).  ``total_cost_diff`` is held to the JAX
function with and without a cost's value differences (the fallback to a
difference of stage values), soft penalties included, and the SQP line
search's ``_diff_metrics`` must take the fallback for a cost without them.
"""

import jax
import numpy as np
import pytest
import torch

from trajoptmpcreference_tpu.models import plants as JP
from trajoptmpcreference_tpu.models.urdf import serial_arm as jax_serial_arm
from trajoptmpcreference_tpu.solvers import constraints as JC
from trajoptmpcreference_tpu.solvers import costs as JCost
from trajoptmpcreference_tpu_torch import convert
from trajoptmpcreference_tpu_torch.models import plants as TP
from trajoptmpcreference_tpu_torch.solvers import costs as TCost
from trajoptmpcreference_tpu_torch.solvers.sqp import make_sqp

jax.config.update("jax_enable_x64", True)

K = 6
Q = np.diag([1.0, 2.0, 3.0, 0.4])
QF = 10.0 * np.eye(4)
R = np.array([[0.1, 0.02], [0.02, 0.2]])
XG = np.array([0.5, 1.5, 0.1, -0.2])
QF_START = 3
f64 = torch.float64


def t(a):
    return torch.tensor(np.asarray(a), dtype=f64)


@pytest.fixture(scope="module")
def plants():
    robot = jax_serial_arm(2)
    return (JP.URDFPlant(robot=robot),
            TP.URDFPlant(robot=convert.robot_from_numpy(robot)))


@pytest.fixture(scope="module")
def points():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((K, 4))
    u = rng.standard_normal((K, 2))
    return (x, u, x + 0.01 * rng.standard_normal((K, 4)),
            u + 0.01 * rng.standard_normal((K, 2)), np.arange(K))


def _costs(kind, plants):
    jp, tp = plants
    a = (Q, QF, R, XG)
    if kind == "quadratic":
        return (JCost.QuadraticCost(*a, QF_start=QF_START),
                TCost.QuadraticCost(*map(t, a), QF_start=QF_START))
    if kind == "arm":
        return (JCost.ArmCost(*a, l1=1.0, l2=1.0, QF_start=QF_START),
                TCost.ArmCost(*map(t, a), l1=1.0, l2=1.0, QF_start=QF_START))
    if kind == "numerical":
        return (JCost.NumericalCost(jp, *a, QF_start=QF_START),
                TCost.NumericalCost(tp, *map(t, a), QF_start=QF_START))
    mode = int(kind[-1])
    return (JCost.UrdfCost(jp, *a, QF_start=QF_START, hess_mode=mode),
            TCost.UrdfCost(tp, *map(t, a), QF_start=QF_START, hess_mode=mode))


def _rel(out, ref):
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return float(np.abs(out.numpy() - ref).max() / max(np.abs(ref).max(), 1e-300))


@pytest.mark.parametrize("kind", ["quadratic", "arm", "numerical", "urdf_hess1",
                                  "urdf_hess2", "urdf_hess3"])
def test_cost_matches_jax(kind, plants, points):
    jc, tc = _costs(kind, plants)
    x, u, xc, uc, ks = points
    jpar = jc.default_params
    tpar = convert.cost_params_from_numpy(*jpar, device="cpu")
    v = lambda f, *a: jax.vmap(f, in_axes=(None,) + (0,) * len(a))(jpar, *a)
    tx, tu, txc, tuc = map(t, (x, u, xc, uc))
    tk = torch.tensor(ks)
    g, H = tc.stage_derivatives(tpar, tx, tu, tk)
    gN, HN = tc.term_derivatives(tpar, tx, tk)
    pairs = {
        "stage_value": (tc.stage_value(tpar, tx, tu, tk), v(jc.stage_value, x, u, ks)),
        "term_value": (tc.term_value(tpar, tx, tk), v(jc.term_value, x, ks)),
        "stage_gradient": (tc.stage_gradient(tpar, tx, tu, tk),
                           v(jc.stage_gradient, x, u, ks)),
        "term_gradient": (tc.term_gradient(tpar, tx, tk), v(jc.term_gradient, x, ks)),
        "stage_derivatives g": (g, v(jc.stage_gradient, x, u, ks)),
        "stage_derivatives H": (H, v(jc.stage_hessian, x, u, ks)),
        "term_derivatives g": (gN, v(jc.term_gradient, x, ks)),
        "term_derivatives H": (HN, v(jc.term_hessian, x, ks)),
    }
    assert (tc.stage_value_diff is None) == (jc.stage_value_diff is None)
    assert tc.xu_coupled == jc.xu_coupled
    if jc.stage_value_diff is not None:
        pairs["stage_value_diff"] = (tc.stage_value_diff(tpar, tx, tu, txc, tuc, tk),
                                     v(jc.stage_value_diff, x, u, xc, uc, ks))
        pairs["term_value_diff"] = (tc.term_value_diff(tpar, tx, txc, tk),
                                    v(jc.term_value_diff, x, xc, ks))
    tol = 1e-6 if kind == "numerical" else 1e-10
    for name, (out, ref) in pairs.items():
        assert _rel(out, ref) < tol, (kind, name, _rel(out, ref))


def test_exact_hessian_differentiates_the_plain_kinematics(plants, points):
    """hess_mode 1 differentiates LaneKinematics' plain functions, never the
    dispatching task_vec (kernel K3 on the card): its derivatives call
    task_vec exactly as often as the Gauss-Newton mode's (once, for the
    residual of the gradient)."""
    kin = plants[1].kinematics
    x, u, _, _, ks = points
    calls = []
    saved = kin.task_vec

    def counting(q, qd):
        calls.append(q.shape)
        return saved(q, qd)

    kin.task_vec = counting
    try:
        for kind in ("urdf_hess0", "urdf_hess1"):
            _, tc = _costs(kind, plants)
            calls.clear()
            tc.term_derivatives(tc.default_params, t(x), torch.tensor(ks))
            assert calls == [(2, K)], (kind, calls)
            calls.clear()
            tc.stage_derivatives(tc.default_params, t(x), t(u), torch.tensor(ks))
            assert calls == [(2, K)], (kind, calls)
    finally:
        kin.task_vec = saved


def _trajectories(seed, B, N):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((B, 4, N))
    U = 3.0 * rng.standard_normal((B, 2, N - 1))
    return (X, U, X + 0.05 * rng.standard_normal(X.shape),
            U + 0.05 * rng.standard_normal(U.shape))


@pytest.mark.parametrize("kind", ["urdf_hess0", "numerical"])
def test_total_cost_diff_matches_jax(kind, plants):
    """Per-stage differences, soft penalties included: the residual form
    (UrdfCost) and the fallback to a difference of stage values
    (NumericalCost, which has no value differences)."""
    B, N = 3, 7
    jc, tc = _costs(kind, plants)
    jset = JC.ConstraintSet(2, 2, 2, N).with_torque_limits(
        2.0, -2.0, "AUGMENTED_LAGRANGIAN")
    tset = convert.constraint_set_from_numpy(jset)
    js = jset.init_state()
    ts = convert.soft_state_from_numpy(js, device="cpu")
    ts = tuple(type(s)(*(a.expand((B,) + a.shape) for a in s)) for s in ts)
    X, U, Xc, Uc = _trajectories(5, B, N)
    ref = jax.vmap(lambda *a: JCost.total_cost_diff(
        jc, jset, js, N, *a, jc.default_params))(X, U, Xc, Uc)
    out = TCost.total_cost_diff(tc, tset, ts, N, *map(t, (X, U, Xc, Uc)),
                                convert.cost_params_from_numpy(
                                    *jc.default_params, device="cpu"))
    assert out.shape == (B,)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-10)
    # the same as summing the stage values' differences by hand
    p = tc.default_params
    ks = torch.arange(N - 1)
    parts = lambda X_, U_: (tc.stage_value(p, t(X_).transpose(1, 2)[:, :-1],
                                           t(U_).transpose(1, 2), ks).sum(-1)
                            + tc.term_value(p, t(X_)[:, :, -1:].transpose(1, 2),
                                            torch.tensor([N - 1]))[:, 0])
    soft_free = TCost.total_cost_diff(tc, convert.constraint_set_from_numpy(
        JC.ConstraintSet(2, 2, 2, N)), (), N, *map(t, (X, U, Xc, Uc)), p)
    np.testing.assert_allclose(soft_free.numpy(), (parts(Xc, Uc) - parts(X, U)).numpy(),
                               rtol=1e-9)


def test_sqp_line_search_takes_the_fallback(plants):
    """_diff_metrics on a cost without stage_value_diff (NumericalCost):
    the per-stage fallback, equal to the JAX line search's dJ.  Calling the
    missing difference would raise TypeError."""
    B, N = 2, 6
    jc, tc = _costs("numerical", plants)
    assert tc.stage_value_diff is None and tc.term_value_diff is None
    solver = make_sqp(plants[1], tc, None, N, 0.1, method="S")
    X, U, Xc, Uc = _trajectories(9, B, N)
    xs = t(X[:, :, 0])
    dJ, c = solver._diff_metrics(*map(t, (X, U, Xc, Uc)), xs,
                                 tc.default_params, ())
    jset = JC.ConstraintSet(2, 2, 2, N)
    ref = jax.vmap(lambda *a: JCost.total_cost_diff(
        jc, jset, jset.init_state(), N, *a, jc.default_params))(X, U, Xc, Uc)
    assert dJ.shape == c.shape == (B,)
    np.testing.assert_allclose(dJ.numpy(), np.asarray(ref), rtol=1e-10)
    assert bool(torch.isfinite(c).all())
