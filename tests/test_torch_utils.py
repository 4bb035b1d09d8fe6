"""The port's utilities (utils/trace.py, flops.py, timing.py), in f64 on the
CPU: the traced SQP round against the untraced solve, the reference's
arm2_S golden and the JAX package's solve_traced, the PCG dual trace, and
the operation count and timer.  Ports tests/test_utils.py, whose trace
tests compile whole solvers (marked slow there); here the one JAX compile
is a pendulum at N = 10."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajoptmpcreference_tpu import PendulumPlant as JaxPendulumPlant
from trajoptmpcreference_tpu import QuadraticCost as JaxQuadraticCost
from trajoptmpcreference_tpu import SQPOptions as JaxSQPOptions
from trajoptmpcreference_tpu import make_sqp as jax_make_sqp
from trajoptmpcreference_tpu.utils import solve_traced as jax_solve_traced
from trajoptmpcreference_tpu_torch import (
    PendulumPlant,
    QuadraticCost,
    SQPOptions,
    URDFPlant,
    UrdfCost,
    make_sqp,
    serial_arm,
)
from trajoptmpcreference_tpu_torch.utils import (
    SQPTrace,
    cost_analysis,
    solve_traced,
    time_fn,
)

GOLDEN = pathlib.Path(__file__).parent / "golden"
f64 = torch.float64


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and under several test workers torch's thread pool only contends with
    the other workers' (a closed loop here ran ~30x its one-process time
    under the six-worker tier-1 run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.tensor(np.asarray(a), dtype=f64)


def _arm_solver(use_lanes=True, method="S", ref_compat=False, **opts):
    """tests/test_utils.py::_arm_solver (2-joint arm, N = 10, dt = 0.1)."""
    plant = URDFPlant(robot=serial_arm(2), use_lanes=use_lanes)
    cost = UrdfCost(plant, torch.eye(4, dtype=f64), 100.0 * torch.eye(4, dtype=f64),
                    0.1 * torch.eye(2, dtype=f64), t([0.5, 1.5, 0.0, 0.0]),
                    ref_compat=ref_compat)
    opts = dict(dict(expected_reduction_min=-100.0, max_iter=30), **opts)
    return make_sqp(plant, cost, None, 10, 0.1, method=method,
                    options=SQPOptions(**opts))


def _zeros(B):
    return torch.zeros((B, 4, 10), dtype=f64), torch.zeros((B, 2, 9), dtype=f64)


@pytest.mark.parametrize("use_lanes", [True, False])
def test_trace_matches_untraced_solve(use_lanes):
    """tests/test_utils.py::test_trace_matches_untraced_solve, on the lanes
    plant and on the per-sample plant."""
    solver = _arm_solver(use_lanes)
    X, U, tr = solve_traced(solver, *_zeros(1))
    res = solver.solve(*_zeros(1))
    assert float((U - res.U).abs().max()) < 1e-10
    assert torch.equal(tr.exit_code, res.exit_sqp)
    it = int(tr.iters[0])
    assert it == int(res.sqp_iters[0]) + 1   # the exiting iteration counts
    live = tr.live[0]
    assert bool(live[:it].all()) and not bool(live[it:].any())
    J = tr.J[0][live]
    assert bool((J[1:] - J[:-1] <= 1e-9).all())
    assert bool(tr.accepted[0][live][:-1].all())   # every step until the exit
    for name in ("alpha", "rho", "D", "reduction_ratio", "J", "c", "merit"):
        assert bool((getattr(tr, name)[0][~live] == 0).all()), name


def test_trace_matches_reference_golden():
    """The traced round reproduces the reference's arm2 method-S run
    (tests/test_sqp_parity.py:70-83, as the untraced solve does)."""
    gold = np.load(GOLDEN / "arm2_S.npz")
    solver = _arm_solver(ref_compat=True, max_iter=100)
    X, U, tr = solve_traced(solver, *_zeros(1))
    assert int(tr.exit_code[0]) == int(gold["exit_sqp"])
    assert np.abs(U[0].numpy() - gold["u"]).max() < 1e-9
    assert np.abs(X[0].numpy() - gold["x"]).max() < 1e-9


def test_trace_batched_shapes():
    """tests/test_utils.py::test_trace_is_vmappable: (B, max_iter) fields,
    and each scenario's rows as when it is traced alone."""
    solver = _arm_solver()
    rng = np.random.default_rng(4)
    x0 = t(0.3 * rng.standard_normal((3, 4, 1))).expand(3, 4, 10).contiguous()
    u0 = torch.zeros((3, 2, 9), dtype=f64)
    X, U, tr = solve_traced(solver, x0, u0)
    assert isinstance(tr, SQPTrace)
    for name in ("J", "c", "merit", "alpha", "rho", "D", "reduction_ratio",
                 "pcg_iters", "accepted", "live"):
        assert getattr(tr, name).shape == (3, 30), name
    assert tr.exit_code.shape == tr.iters.shape == (3,)
    assert bool((tr.exit_code == 1).all())
    assert tr.pcg_nu is None and tr.pcg_resid is None
    X1, U1, tr1 = solve_traced(solver, x0[1:2], u0[1:2])
    assert float((U1[0] - U[1]).abs().max()) < 1e-10
    assert int(tr1.iters[0]) == int(tr.iters[1])
    assert torch.equal(tr1.live[0], tr.live[1])


def test_trace_linsys_dual_trace():
    """tests/test_utils.py::test_trace_linsys_dual_trace: with trace_linsys
    the PCG-SS round carries |nu| and the true residual per SQP
    iteration; the untraced solver takes the same iterates."""
    kw = dict(max_iter=8, max_iter_linSys=40, exit_tolerance_linSys=1e-10)
    solver = _arm_solver(method="PCG-SS", trace_linsys=True, **kw)
    X, U, tr = solve_traced(solver, *_zeros(1))
    assert tr.pcg_nu.shape == tr.pcg_resid.shape == (1, 8, 41)
    it0 = int(tr.pcg_iters[0, 0])
    assert it0 > 0
    nu, resid = tr.pcg_nu[0, 0], tr.pcg_resid[0, 0]
    assert float(nu[it0]) < 1e-10
    assert float(resid[it0]) < 1e-4 * max(float(resid[0]), 1.0)
    res = _arm_solver(method="PCG-SS", **kw).solve(*_zeros(1))
    assert float((U - res.U).abs().max()) < 1e-10
    # the fused PCG carries no dual trace (as JAX with use_pallas_pcg)
    fused = make_sqp(solver.plant, solver.cost, None, 10, 0.1, method="PCG-SS",
                     options=solver.options, use_kernel_pcg=True)
    assert solve_traced(fused, *_zeros(1))[2].pcg_nu is None


def test_pendulum_trace_matches_jax():
    """The pendulum's traced round (method S, N = 10) against JAX
    solve_traced, field by field, at 1e-10 of each field's max."""
    Q, QF, R, xg = np.eye(2), 10.0 * np.eye(2), 0.1 * np.eye(1), np.array([3.14, 0.0])
    opts = dict(expected_reduction_min=-100.0, max_iter=12)
    jsolver = jax_make_sqp(JaxPendulumPlant(),
                           JaxQuadraticCost(*map(jnp.asarray, (Q, QF, R, xg))),
                           None, 10, 0.1, method="S",
                           options=JaxSQPOptions(**opts))
    rng = np.random.default_rng(3)
    x0 = np.repeat(0.2 * rng.standard_normal((2, 1)), 10, axis=1)
    u0 = 0.1 * rng.standard_normal((1, 9))
    JX, JU, jtr = jax.jit(lambda a, b: jax_solve_traced(jsolver, a, b))(
        jnp.asarray(x0), jnp.asarray(u0))
    solver = make_sqp(PendulumPlant(), QuadraticCost(*map(t, (Q, QF, R, xg))),
                      None, 10, 0.1, method="S", options=SQPOptions(**opts))
    X, U, tr = solve_traced(solver, t(x0)[None], t(u0)[None])
    rel = lambda a, b: float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))
    assert rel(U[0].numpy(), np.asarray(JU)) < 1e-10
    assert rel(X[0].numpy(), np.asarray(JX)) < 1e-10
    for name in ("J", "c", "merit", "alpha", "rho", "D", "reduction_ratio"):
        assert rel(getattr(tr, name)[0].numpy(), np.asarray(getattr(jtr, name))) \
            < 1e-10, name
    for name in ("pcg_iters", "accepted", "live", "exit_code", "iters"):
        assert np.array_equal(getattr(tr, name)[0].numpy(),
                              np.asarray(getattr(jtr, name))), name


def test_cost_analysis_reports_flops():
    """tests/test_utils.py::test_cost_analysis_reports_flops; on the CPU the
    device keys are absent."""
    plant = PendulumPlant()
    cost = QuadraticCost(torch.eye(2, dtype=f64), torch.eye(2, dtype=f64),
                         torch.eye(1, dtype=f64), t([3.14, 0.0]))
    solver = make_sqp(plant, cost, None, 10, 0.1, method="S")
    stats = cost_analysis(solver.solve, torch.zeros((1, 2, 10), dtype=f64),
                          torch.zeros((1, 1, 9), dtype=f64))
    assert stats["flops"] > 0
    assert "device_ops" not in stats
    x = torch.ones(64, 32, dtype=f64)
    assert cost_analysis(lambda a: a @ a.T, x)["flops"] == 2 * 64 * 64 * 32


def test_time_fn_syncs():
    """tests/test_utils.py::test_time_fn_syncs."""
    x = torch.ones((256, 256))
    dt, out = time_fn(lambda a: a @ a, x, reps=2)
    assert dt > 0 and out.shape == (256, 256)
