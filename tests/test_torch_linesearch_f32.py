"""The port's f32 line search against its own f64 one, at the bars of
tests/test_linesearch_f32.py (:104, :197, :227, :255), on the CPU.

Near convergence the merit change is many orders below J; a difference
of two f32 totals keeps no significant bits of it, so acceptance turns
into noise.  The port takes it from per-stage differences
(``SQPSolver.total_cost_diff``), as JAX does.

* total_cost_diff in f32 against f64 at J ~ 1e6 and |dJ| < 1e-3 J: median
  relative error over 8 perturbations under 2e-2.
* line_search in f32 takes f64's accept decision and alpha, with dJ to
  2e-2, at a near-converged point of the 6-DoF arm (weights x 1e4).
* Scaling Q, QF, R (and mu) by s in {1, 1e-2, 1e-3} keeps the f32
  decision and alpha, and dJ scales with s (5e-2).
* The parallel alpha ladder selects the sequential loop's alpha,
  acceptance, ls_iter, candidate (1e-12) and merit (rtol 1e-12), for a
  strict and a loose gate, and whole solves agree (1e-9).
"""

import dataclasses

import numpy as np
import pytest
import torch

from trajoptmpcreference_tpu_torch import (
    SQPOptions,
    URDFPlant,
    UrdfCost,
    make_sqp,
    serial_arm,
)

f32, f64 = torch.float32, torch.float64
# amplify J so f32 totals have ~no bits left for small differences
WEIGHT = 1e4


def _problem(weight_scale=1.0, dtype=f64, N=16, max_iter=12):
    plant = URDFPlant(robot=serial_arm(6))
    s = weight_scale
    t = lambda a: torch.tensor(a, dtype=dtype)
    cost = UrdfCost(plant, s * torch.diag(t([1.0, 1.0, 1.0, 0.1, 0.1, 0.1])),
                    s * 100.0 * torch.eye(6, dtype=dtype),
                    s * 0.01 * torch.eye(plant.nu, dtype=dtype),
                    t([3.0, 2.0, 0.0, 0.0, 0.0, 0.0]))
    opts = SQPOptions(expected_reduction_min=-100.0, exit_tolerance=s * 1e-6,
                      max_iter=max_iter)
    return make_sqp(plant, cost, None, N, 0.015, method="S", options=opts)


def _near_converged_point(solver):
    """A short f64 solve from rest: (X, U) close to a solution."""
    N, nx, nu = solver.N, solver.plant.nx, solver.plant.nu
    res = solver.solve(torch.zeros((1, nx, N), dtype=f64),
                       torch.zeros((1, nu, N - 1), dtype=f64))
    return res.X, res.U


def _first_step(solver, X, U):
    """(xs, dxu, J0, c0, merit0) of the QP step at (X, U), rho = 1e-3."""
    xs = X[..., 0]
    p = solver.cost.default_params
    guess = X.new_zeros((1, solver.N, solver.kkt.bs))
    dxu, _, _, _ = solver.solve_qp(X, U, xs, p, (), X.new_full((1,), 1e-3), guess)
    J0 = solver.total_cost(X, U, p, ())
    c0 = solver.total_violation(X, U, xs)
    mu = solver.merit_weight(J0, c0)
    return xs, dxu, J0, c0, J0 + mu * c0


@pytest.fixture(scope="module")
def wbase():
    """The WEIGHT-scaled problem in both precisions and one near-converged
    point (a full f64 solve)."""
    sol64 = _problem(WEIGHT, f64)
    sol32 = _problem(WEIGHT, f32)
    X64, U64 = _near_converged_point(sol64)
    return sol64, sol32, X64, U64


@pytest.fixture(scope="module")
def ref1():
    """The scale-1 f64 reference: point, QP step and line search."""
    sol64 = _problem(1.0, f64)
    X64, U64 = _near_converged_point(sol64)
    xs, dxu, J0, c0, merit0 = _first_step(sol64, X64, U64)
    ls = sol64.line_search(X64, U64, dxu, J0, c0, merit0, xs,
                           sol64.cost.default_params, ())
    return X64, U64, xs, dxu, ls, _problem(1.0, f32)


def test_total_cost_diff_f32_accuracy(wbase):
    sol64, sol32, X64, U64 = wbase
    # perturb in f32 (as the line search does); the oracle evaluates the
    # same f32 points in f64, which isolates the accumulation error
    X32, U32 = X64.to(f32), U64.to(f32)
    p64, p32 = sol64.cost.default_params, sol32.cost.default_params
    J64 = float(sol64.total_cost(X32.double(), U32.double(), p64, ())[0])
    rels = []
    for seed in range(8):
        rng = np.random.default_rng(seed)
        eps = 1e-5 if seed % 2 else 1e-4
        Xc32 = X32 + torch.tensor(eps * rng.standard_normal(X64.shape), dtype=f32)
        Uc32 = U32 + torch.tensor(eps * rng.standard_normal(U64.shape), dtype=f32)
        d64 = float(sol64.total_cost_diff(X32.double(), U32.double(),
                                          Xc32.double(), Uc32.double(), p64, ())[0])
        assert abs(d64) < 1e-3 * abs(J64)            # the hard regime
        d32 = float(sol32.total_cost_diff(X32, U32, Xc32, Uc32, p32, ())[0])
        rels.append(abs(d32 - d64) / abs(d64))
    assert np.median(rels) < 2e-2, rels


def test_line_search_f32_matches_f64_decision(wbase):
    sol64, sol32, X64, U64 = wbase
    xs, dxu, J0, c0, merit0 = _first_step(sol64, X64, U64)
    ls64 = sol64.line_search(X64, U64, dxu, J0, c0, merit0, xs,
                             sol64.cost.default_params, ())
    p32 = sol32.cost.default_params
    X32, U32, xs32 = X64.to(f32), U64.to(f32), xs.to(f32)
    J32 = sol32.total_cost(X32, U32, p32, ())
    c32 = sol32.total_violation(X32, U32, xs32)
    mu32 = sol32.merit_weight(J32, c32)
    ls32 = sol32.line_search(X32, U32, dxu.to(f32), J32, c32, J32 + mu32 * c32,
                             xs32, p32, ())
    assert bool(ls32.accepted[0]) == bool(ls64.accepted[0])
    assert float(ls32.alpha[0]) == pytest.approx(float(ls64.alpha[0]))
    assert float(ls32.dJ[0]) == pytest.approx(float(ls64.dJ[0]), rel=2e-2, abs=1e-8)


@pytest.mark.parametrize("scale", [1.0, 1e-2, 1e-3])
def test_line_search_f32_scale_invariance(scale, ref1):
    """Q, QF, R and mu scaled by s enter through the cost parameters; the
    f32 decision must not flip (round 1 of the reference's port found the
    subtraction-form search rejecting every step at s = 1e-3)."""
    X64, U64, xs, dxu, ls_ref, sol32 = ref1
    p1 = sol32.cost.default_params
    ps = p1._replace(Q=p1.Q * scale, QF=p1.QF * scale, R=p1.R * scale)
    X32, U32, xs32 = X64.to(f32), U64.to(f32), xs.to(f32)
    J0 = sol32.total_cost(X32, U32, ps, ())
    c0 = sol32.total_violation(X32, U32, xs32)
    mu = torch.tensor(10.0 * scale, dtype=f32)
    ls = sol32.line_search(X32, U32, dxu.to(f32), J0, c0, J0 + mu * c0, xs32,
                           ps, (), mu=mu)
    assert bool(ls.accepted[0]) == bool(ls_ref.accepted[0]), scale
    assert float(ls.alpha[0]) == pytest.approx(float(ls_ref.alpha[0])), scale
    assert float(ls.dJ[0]) == pytest.approx(scale * float(ls_ref.dJ[0]),
                                            rel=5e-2, abs=1e-10), scale


def test_parallel_line_search_matches_sequential():
    plant = URDFPlant(robot=serial_arm(3))
    N = 8
    cost = UrdfCost(plant, torch.eye(6, dtype=f64), 50.0 * torch.eye(6, dtype=f64),
                    0.01 * torch.eye(3, dtype=f64),
                    torch.tensor([1.0, 1.5, 0, 0, 0, 0.0], dtype=f64))
    rng = np.random.default_rng(5)
    x0 = torch.tensor(0.2 * rng.standard_normal(plant.nx))
    X = x0[None, :, None].expand(1, plant.nx, N).clone()
    U = torch.tensor(0.1 * rng.standard_normal((1, plant.nu, N - 1)))
    base = make_sqp(plant, cost, None, N, 0.05, method="S", options=SQPOptions())
    xs, cp = X[..., 0], cost.default_params
    blocks = base.kkt.form_blocks(X, U, xs, cp, ())
    dxu, _, _ = base.kkt.solve_schur(blocks, X.new_full((1,), 1e-3))
    J, c = base.base_metrics(X, U, xs, cp, ())
    for reduction_min in (0.05, -100.0):   # the strict gate rejects more
        opts = SQPOptions(expected_reduction_min=reduction_min)
        seq = make_sqp(plant, cost, None, N, 0.05, method="S", options=opts)
        par = make_sqp(plant, cost, None, N, 0.05, method="S",
                       options=dataclasses.replace(opts, parallel_line_search=True))
        mu = seq.merit_weight(J, c)
        a = seq.line_search(X, U, dxu, J, c, J + mu * c, xs, cp, ())
        b = par.line_search(X, U, dxu, J, c, J + mu * c, xs, cp, ())
        assert float(a.alpha[0]) == float(b.alpha[0]), reduction_min
        assert bool(a.accepted[0]) == bool(b.accepted[0])
        assert int(a.ls_iter[0]) == int(b.ls_iter[0])
        torch.testing.assert_close(b.Xc, a.Xc, rtol=0, atol=1e-12)
        torch.testing.assert_close(b.merit_new, a.merit_new, rtol=1e-12, atol=0)
    r_seq, r_par = seq.solve(X, U), par.solve(X, U)
    torch.testing.assert_close(r_par.U, r_seq.U, rtol=0, atol=1e-9)
    assert torch.equal(r_par.exit_sqp, r_seq.exit_sqp)
