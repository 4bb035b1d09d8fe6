"""The port's analytic plants against the JAX package (f64, CPU).

DoubleIntegratorPlant, PendulumPlant and CartPolePlant: xdot, dxdot, step
and step_gradient at seeded states and controls, integrators 0 (Euler) and
1 (semi-implicit Euler), and for each of 2-4 (midpoint, RK3, RK4) every
plant, to 1e-12 — the cart-pole's Jacobian is written by
hand in the port and taken by ``jax.jacfwd`` in the JAX package.  The port
takes the batch as leading dimensions; the JAX functions are vmapped.
"""

import jax
import numpy as np
import pytest
import torch

from trajoptmpcreference_tpu.models import plants as JP
from trajoptmpcreference_tpu_torch import convert
from trajoptmpcreference_tpu_torch.models import plants as TP

jax.config.update("jax_enable_x64", True)

# non-default parameters, so each one is carried across
PARAMS = {
    "DoubleIntegratorPlant": dict(mass=1.7),
    "PendulumPlant": dict(mass=1.3, length=0.8, damping=0.2, gravity=9.7),
    "CartPolePlant": dict(cart_mass=1.2, pole_mass=0.3, pole_length=0.6,
                          gravity=9.8),
}
DT = 0.05
TOL = 1e-12


def _pair(name, integrator_type):
    jp = getattr(JP, name)(integrator_type=integrator_type, **PARAMS[name])
    tp = convert.analytic_plant_from_numpy(jp.name, integrator_type,
                                           **PARAMS[name])
    return jp, tp


def _inputs(jp, seed):
    rng = np.random.default_rng(seed)
    # batch (3, 5): two leading dimensions on the port's side
    return (2.0 * rng.standard_normal((3, 5, jp.nx)),
            3.0 * rng.standard_normal((3, 5, jp.nu)))


def _jax_batched(fn, x, u, *extra):
    f = jax.vmap(jax.vmap(lambda a, b: fn(a, b, *extra)))
    out = f(x, u)
    return [np.asarray(o) for o in (out if isinstance(out, tuple) else (out,))]


@pytest.mark.parametrize("integrator_type", [0, 1])
@pytest.mark.parametrize("name", sorted(PARAMS))
def test_analytic_plant_matches_jax(name, integrator_type):
    _check_matches_jax(name, integrator_type)


@pytest.mark.parametrize("integrator_type", [2, 3, 4])
def test_higher_order_integrators_still_raise(integrator_type):
    """Integrators 2-4 once raised here; each now matches the JAX plant for
    every analytic plant (the name is kept)."""
    for name in sorted(PARAMS):
        _check_matches_jax(name, integrator_type)


def _check_matches_jax(name, integrator_type):
    jp, tp = _pair(name, integrator_type)
    assert (tp.nq, tp.nv, tp.nu, tp.nx) == (jp.nq, jp.nv, jp.nu, jp.nx)
    assert tp.name == jp.name
    x, u = _inputs(jp, 3 + integrator_type)
    tx, tu = torch.tensor(x), torch.tensor(u)
    cases = {
        "xdot": (_jax_batched(jp.xdot, x, u), [tp.xdot(tx, tu)]),
        "dxdot": (_jax_batched(jp.dxdot, x, u), [tp.dxdot(tx, tu)]),
        "step": (_jax_batched(jp.step, x, u, DT), [tp.step(tx, tu, DT)]),
        "step_gradient": (_jax_batched(jp.step_gradient, x, u, DT),
                          list(tp.step_gradient(tx, tu, DT))),
    }
    for fn, (ref, out) in cases.items():
        assert len(ref) == len(out), fn
        for r, o in zip(ref, out):
            assert o.shape == r.shape, (fn, o.shape, r.shape)
            assert o.dtype == torch.float64
            err = np.abs(o.numpy() - r).max() / max(np.abs(r).max(), 1.0)
            assert err < TOL, (fn, err)


def test_cartpole_jacobian_matches_autodiff():
    """The hand-written cart-pole Jacobian against torch.func.jacfwd of
    the port's own xdot, at states past +-pi."""
    tp = TP.CartPolePlant()
    rng = np.random.default_rng(7)
    x = torch.tensor(4.0 * rng.standard_normal((6, 4)))
    u = torch.tensor(rng.standard_normal((6, 1)))
    f = lambda xu: tp.xdot(xu[:4], xu[4:])
    J = torch.func.vmap(torch.func.jacfwd(f))(torch.cat([x, u], -1))
    assert torch.allclose(tp.dxdot(x, u), J, rtol=0, atol=1e-12)


def test_analytic_plant_from_numpy_rejects_unknowns():
    with pytest.raises(ValueError, match="unknown analytic plant"):
        convert.analytic_plant_from_numpy("acrobot")
    with pytest.raises(ValueError, match="parameters"):
        convert.analytic_plant_from_numpy("pendulum", length=1.0, mass=1.0,
                                          inertia=2.0)
