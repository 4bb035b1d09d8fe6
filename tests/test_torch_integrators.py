"""The port's integrators 2-4 (midpoint, RK3, RK4) against the JAX package
(f64, CPU).

* step and step_gradient of the pendulum, the cart-pole and the URDF arms
  serial_arm(2) / serial_arm(6) (plain path), for types 2-4, against the
  JAX plants to 1e-12, sample by sample (the JAX URDF plant on its
  per-sample dynamics, ``use_lanes=False``: its lanes path under vmap
  takes minutes to compile at RK4).
* A and B against torch.func.jacfwd of the port's own step to 1e-9, for
  every type (tests/test_integrators.py:30-40): the gradients are the
  exact chain-rule composition, not the reference's (README.md:284-296).
* One-step error order on the pendulum (tests/test_integrators.py:43):
  Euler ~4x, midpoint ~8x, RK4 ~32x when dt halves.
* A batch gives, bit for bit, what each sample gives alone (the analytic
  plants; on the URDF arm to 1e-12 of the largest value, since the plain
  dynamics' sums over lanes round differently at another lane count:
  dxdot itself moves by ~1e-15 relative).
* The arm2 midpoint solve (method "S", ref_compat) against
  tests/golden/arm2_S_midpoint.npz with the bar of
  tests/test_sqp_parity.py:86-121 (the same exit, J <= 1.05 x the golden's
  cost: the reference's midpoint is a different discretization), and
  against JAX ``make_sqp`` with integrator_type=2 to 1e-9.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajoptmpcreference_tpu.models import plants as JP
from trajoptmpcreference_tpu.models.urdf import serial_arm as jserial_arm
from trajoptmpcreference_tpu.solvers.costs import UrdfCost as JUrdfCost
from trajoptmpcreference_tpu.solvers.sqp import SQPOptions as JSQPOptions
from trajoptmpcreference_tpu.solvers.sqp import make_sqp as jmake_sqp
from trajoptmpcreference_tpu_torch import (
    CartPolePlant,
    PendulumPlant,
    SQPOptions,
    URDFPlant,
    UrdfCost,
    make_sqp,
    serial_arm,
)

jax.config.update("jax_enable_x64", True)

GOLDEN = pathlib.Path(__file__).parent / "golden"
f64 = torch.float64
DT = 0.07
PLANTS = {
    "pendulum": (lambda it: JP.PendulumPlant(integrator_type=it),
                 lambda it: PendulumPlant(integrator_type=it)),
    "cartpole": (lambda it: JP.CartPolePlant(integrator_type=it),
                 lambda it: CartPolePlant(integrator_type=it)),
    "arm2": (lambda it: JP.URDFPlant(robot=jserial_arm(2), integrator_type=it,
                                     use_lanes=False),
             lambda it: URDFPlant(robot=serial_arm(2), integrator_type=it)),
    "arm6": (lambda it: JP.URDFPlant(robot=jserial_arm(6), integrator_type=it,
                                     use_lanes=False),
             lambda it: URDFPlant(robot=serial_arm(6), integrator_type=it)),
}


def _inputs(nx, nu, seed, B=5):
    rng = np.random.default_rng(seed)
    return 0.5 * rng.standard_normal((B, nx)), 0.5 * rng.standard_normal((B, nu))


@pytest.mark.parametrize("itype", [2, 3, 4])
@pytest.mark.parametrize("name", sorted(PLANTS))
def test_step_and_gradient_match_jax(name, itype):
    jp, tp = (make(itype) for make in PLANTS[name])
    x, u = _inputs(tp.nx, tp.nu, 10 * itype + len(name))
    both = jax.jit(lambda a, b: (jp.step(a, b, DT), *jp.step_gradient(a, b, DT)))
    refs = [both(a, b) for a, b in zip(x, u)]
    tx, tu = torch.tensor(x), torch.tensor(u)
    outs = [tp.step(tx, tu, DT), *tp.step_gradient(tx, tu, DT)]
    for i, out in enumerate(outs):
        ref = np.stack([np.asarray(r[i]) for r in refs])
        assert out.shape == ref.shape and out.dtype == f64
        err = np.abs(out.numpy() - ref).max() / max(np.abs(ref).max(), 1.0)
        assert err < 1e-12, (name, itype, err)


@pytest.mark.parametrize("itype", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("name", ["pendulum", "cartpole", "arm2"])
def test_step_gradient_matches_autodiff(name, itype):
    tp = PLANTS[name][1](itype)
    x, u = (torch.tensor(a[0]) * 0.6 for a in _inputs(tp.nx, tp.nu, itype))
    A, B = tp.step_gradient(x[None], u[None], DT)
    A_ad = torch.func.jacfwd(lambda xx: tp.step(xx[None], u[None], DT)[0])(x)
    B_ad = torch.func.jacfwd(lambda uu: tp.step(x[None], uu[None], DT)[0])(u)
    torch.testing.assert_close(A[0], A_ad, atol=1e-9, rtol=0)
    torch.testing.assert_close(B[0], B_ad, atol=1e-9, rtol=0)


def test_convergence_order():
    """One-step error ratios for dt -> dt/2 against 64 RK4 substeps:
    Euler O(dt^2) ~4x, midpoint O(dt^3) ~8x, RK4 O(dt^5) ~32x."""
    x = torch.tensor([[0.4, -0.2]], dtype=f64)
    u = torch.tensor([[0.3]], dtype=f64)
    fine = PendulumPlant(integrator_type=4)

    def err(itype, dt):
        xf = x
        for _ in range(64):
            xf = fine.step(xf, u, dt / 64)
        out = PendulumPlant(integrator_type=itype).step(x, u, dt)
        return float(torch.linalg.norm(out - xf))

    for itype, lo, hi in [(0, 3.0, 6.0), (2, 5.5, 12.0), (4, 18.0, 50.0)]:
        r = err(itype, 0.2) / max(err(itype, 0.1), 1e-14)
        assert lo < r < hi, (itype, r)


@pytest.mark.parametrize("itype", [2, 3, 4])
@pytest.mark.parametrize("name", ["pendulum", "cartpole", "arm6"])
def test_batch_matches_each_sample_alone(name, itype):
    tp = PLANTS[name][1](itype)
    x, u = (torch.tensor(a) for a in _inputs(tp.nx, tp.nu, 3, B=4))
    full = [tp.step(x, u, DT), *tp.step_gradient(x, u, DT)]
    for i in range(4):
        one = [tp.step(x[i:i + 1], u[i:i + 1], DT),
               *tp.step_gradient(x[i:i + 1], u[i:i + 1], DT)]
        for a, b in zip(full, one):
            if name == "arm6":
                err = float((a[i] - b[0]).abs().max() / a[i].abs().max())
                assert err < 1e-12, (itype, i, err)
            else:
                assert torch.equal(a[i], b[0]), (name, itype, i)


def test_arm2_midpoint_solve_golden_and_jax():
    gold = np.load(GOLDEN / "arm2_S_midpoint.npz")
    N = 10
    t = lambda a: torch.tensor(a, dtype=f64)
    plant = URDFPlant(robot=serial_arm(2), integrator_type=2)
    cost = UrdfCost(plant, torch.eye(4, dtype=f64), 100.0 * torch.eye(4, dtype=f64),
                    0.1 * torch.eye(2, dtype=f64), t([0.5, 1.5, 0.0, 0.0]),
                    ref_compat=True)
    solver = make_sqp(plant, cost, None, N, 0.1, method="S",
                      options=SQPOptions(expected_reduction_min=-100.0))
    res = solver.solve(torch.zeros((1, 4, N), dtype=f64),
                       torch.zeros((1, 2, N - 1), dtype=f64))
    assert int(res.exit_sqp[0]) == int(gold["exit_sqp"])
    J_gold = solver.total_cost(t(gold["x"])[None], t(gold["u"])[None],
                               cost.default_params, ())
    assert float(res.J[0]) <= 1.05 * float(J_gold[0])

    jplant = JP.URDFPlant(robot=jserial_arm(2), integrator_type=2)
    jcost = JUrdfCost(jplant, jnp.eye(4), 100.0 * jnp.eye(4), 0.1 * jnp.eye(2),
                      jnp.asarray([0.5, 1.5, 0.0, 0.0]), ref_compat=True)
    jsolver = jmake_sqp(jplant, jcost, None, N, 0.1, method="S",
                        options=JSQPOptions(expected_reduction_min=-100.0))
    ref = jax.jit(jsolver.solve)(jnp.zeros((4, N)), jnp.zeros((2, N - 1)))
    assert int(res.exit_sqp[0]) == int(ref.exit_sqp)
    assert int(res.sqp_iters[0]) == int(ref.sqp_iters)
    for out, r in ((res.U[0], ref.U), (res.X[0], ref.X)):
        r = np.asarray(r)
        assert np.abs(out.numpy() - r).max() < 1e-9 * max(np.abs(r).max(), 1.0)
    assert abs(float(J_gold[0]) - float(jsolver.total_cost(
        jnp.asarray(gold["x"]), jnp.asarray(gold["u"]), jcost.default_params,
        ()))) < 1e-9 * float(J_gold[0])
