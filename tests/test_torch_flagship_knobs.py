"""The flagship's knobs of __graft_entry__._flagship (:19-29) in the port.

* ``flagship()`` with the new knobs at their defaults builds what it built
  before them: the same options, plant integrator, cost weights and dt.
* Each knob reaches the solver it builds.
* The RTI flagship (``ls_fixed_alpha=1, rti_step_clip=5``) against
  ``jax.vmap`` of __graft_entry__._flagship_mpc with the Pallas kernels
  off: B = 4, N = 8, 3 closed-loop steps from bench.py's scenarios, f64,
  on the CPU; states, controls and solve costs to 1e-4, as the
  semi-implicit flagship's episode (tests/test_torch_sqp_mpc.py): RTI
  applies every QP step at rho = 1e-3, so the two packages' ~1e-15
  rounding differences grow to ~2e-5 in 3 steps (a one-ulp move of the
  port's own dynamics moves one warm RTI solve by ~5e-5 of max|U| at
  N = 64); equal iteration counts and exit codes.
  The RK4 flagship is tests/test_torch_flagship_rk4.py.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from __graft_entry__ import _flagship_mpc
from trajoptmpcreference_tpu_torch import flagship as F
from trajoptmpcreference_tpu_torch.solvers.sqp import SQPOptions

jax.config.update("jax_enable_x64", True)

N, B = 8, 4
JAX_KW = dict(N=N, dtype=jnp.float64, use_pallas=False, use_pallas_fd=False,
              use_pallas_task=False)
f64 = torch.float64


def test_default_knobs_build_the_same_flagship():
    plant, cost, solver = F.flagship(N=N, dtype=f64, device="cpu")
    assert solver.options == SQPOptions(
        expected_reduction_min=-100.0, exit_tolerance=1e-4,
        exit_tolerance_linSys=1e-4, max_iter=3, max_iter_linSys=40,
        pcg_relative=True, parallel_line_search=True, alpha_factor=0.316,
        alpha_min=0.11, ls_grad_at_base=True, rho_init=1e-3, rho_min=1e-3)
    assert plant.integrator_type == 1 and solver.dt == F.DT == 0.015
    p = cost.default_params
    eye = lambda n: torch.eye(n, dtype=f64)
    assert torch.equal(p.Q, torch.diag(torch.tensor([1.0, 1.0, 1.0, 0.1, 0.1, 0.1],
                                                    dtype=f64)))
    assert torch.equal(p.QF, 100.0 * eye(6)) and torch.equal(p.R, 0.01 * eye(6))
    assert solver.method == "S" and solver.kkt.exact_schur == "cr"


def test_each_knob_reaches_the_solver():
    knobs = dict(integrator_type=4, vel_weight=0.2, r_weight=0.03,
                 qf_weight=50.0, dt=0.02, parallel_ls=False,
                 ls_grad_at_base=False, ls_fixed_alpha=0.5, rti_lean=True,
                 rti_step_clip=5.0, rho_init=1e-2, rho_min=1e-4)
    plant, cost, solver = F.flagship(N=N, dtype=f64, device="cpu", **knobs)
    o = solver.options
    assert plant.integrator_type == 4 and solver.dt == 0.02
    assert (o.parallel_line_search, o.ls_grad_at_base) == (False, False)
    assert (o.ls_fixed_alpha, o.rti_lean, o.rti_step_clip) == (0.5, True, 5.0)
    assert (o.rho_init, o.rho_min) == (1e-2, 1e-4)
    p = cost.default_params
    assert float(p.Q[3, 3]) == 0.2 and float(p.R[0, 0]) == 0.03
    assert float(p.QF[0, 0]) == 50.0
    _, _, ctrl = F.flagship_mpc(N=N, dtype=f64, device="cpu", dt=0.02)
    assert ctrl.solver.dt == 0.02 and ctrl.sim_qd_max == math.pi / F.DT
    assert F.RK4_KNOBS == dict(integrator_type=4)


def _compare_loop(knobs, steps, tol):
    """The port's flagship_mpc(**knobs) against JAX's over ``steps``
    closed-loop steps from bench.py's scenarios."""
    x0s, goals = F.bench_scenarios(B)
    _, jcost, jctrl = _flagship_mpc(**JAX_KW, **knobs)
    cps = jax.vmap(lambda g: jcost.default_params._replace(xg=g))(
        jnp.asarray(goals))
    ref = jax.jit(jax.vmap(lambda x0, cp: jctrl.run(x0, steps=steps,
                                                    cost_params=cp)))(
        jnp.asarray(x0s), cps)
    _, cost, ctrl = F.flagship_mpc(N=N, dtype=f64, device="cpu", **knobs)
    res = ctrl.run(torch.tensor(x0s), steps, cost_params=cost.default_params._replace(
        xg=torch.tensor(goals)))
    np.testing.assert_array_equal(res.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_array_equal(res.exit_codes.numpy(),
                                  np.asarray(ref.exit_codes))
    for field in ("X_applied", "U_applied", "J_solve"):
        r = np.asarray(getattr(ref, field))
        err = np.abs(getattr(res, field).numpy() - r).max() / np.abs(r).max()
        assert err < tol, (field, err)
    return res


def test_rti_flagship_matches_jax():
    res = _compare_loop(dict(ls_fixed_alpha=1.0, rti_step_clip=5.0), 3, 1e-4)
    assert bool(torch.isfinite(res.X_applied).all())
