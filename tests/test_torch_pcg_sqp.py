"""Port's PCG methods in the SQP solver and the MPC loop against the
reference golden and the JAX package.

* arm2 PCG-SS (ref_compat, absolute PCG exit 1e-6 / 100 iterations): the
  same accuracy class as the reference run, J <= J_gold + 0.05, as
  tests/test_sqp_parity.py:178-194 (the reference's PCG iterates are
  chaotic, so bit parity is not meaningful).
* One QP step of arm2 PCG-SS with a nonzero multiplier warm start and the
  PCG dual trace, against the JAX solve_qp: dxu, lam and the traces to
  1e-9 (relative to their scale, f64; at rho = 1, where the block inverses
  are well conditioned).  Only 5 PCG iterations, so the result depends on
  the warm start.
* The PCG-SS flagship (4 SQP iterations, 40 PCG iterations, relative exit
  1e-4) at N = 8, B = 3, f64, one solve against ``jax.vmap`` of
  __graft_entry__._flagship with the Pallas kernels off and the XLA PCG:
  controls to 1e-7 and equal exit codes and iteration counts (the cold
  Schur systems have condition ~1e7-1e9, which amplifies the ~1e-15
  differences of two LU libraries).  The closed-loop episode is
  tests/test_torch_pcg_episode.py.
* use_kernel_pcg (the fused PCG; on CPU tensors K4's plain version) against
  btridiag.pcg in a whole solve: same exit, controls to 1e-8, as
  test_sqp_solve_with_pallas_pcg_matches_xla.
"""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship
from trajoptmpcreference_tpu import make_sqp as jax_make_sqp
from trajoptmpcreference_tpu.models.plants import URDFPlant as JaxURDFPlant
from trajoptmpcreference_tpu.models.urdf import serial_arm as jax_serial_arm
from trajoptmpcreference_tpu.solvers.costs import UrdfCost as JaxUrdfCost
from trajoptmpcreference_tpu.solvers.methods import SQPSolverMethods as JaxMethods
from trajoptmpcreference_tpu.solvers.sqp import SQPOptions as JaxSQPOptions
from trajoptmpcreference_tpu_torch import (
    SQPOptions,
    URDFPlant,
    UrdfCost,
    make_mpc,
    make_sqp,
    serial_arm,
)
from trajoptmpcreference_tpu_torch import flagship as F
from trajoptmpcreference_tpu_torch.convert import sqp_kwargs_from_jax
from trajoptmpcreference_tpu_torch.ops import fused_pcg
from trajoptmpcreference_tpu_torch.solvers.sqp import knot_params

GOLDEN = pathlib.Path(__file__).parent / "golden"
N, B = 8, 3
f64 = torch.float64


def _arm2(method, N=10, dt=0.1, options=None, ref_compat=True, **kw):
    t = lambda a: torch.tensor(a, dtype=f64)
    plant = URDFPlant(robot=serial_arm(2))
    cost = UrdfCost(plant, torch.diag(t([1.0, 1.0, 1.0, 1.0])),
                    torch.diag(t([100.0] * 4)), 0.1 * torch.eye(2, dtype=f64),
                    t([0.5, 1.5, 0.0, 0.0]), ref_compat=ref_compat)
    # the reference's own working example (ref: examples/twolinks.py:87)
    opts = options or SQPOptions(expected_reduction_min=-100.0)
    return make_sqp(plant, cost, None, N, dt, method=method, options=opts, **kw)


def test_arm2_pcg_ss_behavioural_parity_with_golden():
    gold = np.load(GOLDEN / "arm2_PCG_SS.npz")
    solver = _arm2("PCG-SS")
    res = solver.solve(torch.zeros((1, 4, 10), dtype=f64),
                       torch.zeros((1, 2, 9), dtype=f64))
    X, U = torch.tensor(gold["x"])[None], torch.tensor(gold["u"])[None]
    J_gold, _ = solver.base_metrics(X, U, X[..., 0],
                                    knot_params(solver.cost.default_params), ())
    assert bool(torch.isfinite(res.J).all())
    assert float(res.J[0]) <= float(J_gold[0]) + 0.05


def test_qp_step_with_warm_start_and_trace_matches_jax():
    """solve_qp_from_blocks passes the multiplier warm start to PCG (and
    only to PCG) and carries the dual trace when trace_linsys is set."""
    opts = dict(expected_reduction_min=-100.0, max_iter_linSys=5,
                trace_linsys=True)
    solver = _arm2("PCG-SS", options=SQPOptions(**opts))
    jplant = JaxURDFPlant(robot=jax_serial_arm(2))
    jcost = JaxUrdfCost(jplant, jnp.eye(4), 100.0 * jnp.eye(4),
                        0.1 * jnp.eye(2), jnp.array([0.5, 1.5, 0.0, 0.0]),
                        ref_compat=True)
    jsolver = jax_make_sqp(jplant, jcost, None, 10, 0.1, method="PCG-SS",
                           options=JaxSQPOptions(**opts))
    rng = np.random.default_rng(8)
    X = 0.2 * rng.standard_normal((4, 10))
    U = 0.2 * rng.standard_normal((2, 9))
    guess = 0.5 * rng.standard_normal((10, 4))
    rho = 1.0
    jdxu, jlam, jstats, _ = jax.jit(jsolver.solve_qp)(
        jnp.asarray(X), jnp.asarray(U), jnp.asarray(X[:, 0]),
        jcost.default_params, jsolver.cset.init_state(), jnp.asarray(rho),
        jnp.asarray(guess))
    t = lambda a: torch.tensor(a)[None]
    blocks = solver.kkt.form_blocks(t(X), t(U), t(X[:, 0]),
                                    knot_params(solver.cost.default_params), ())
    dxu, lam, stats, _ = solver.solve_qp_from_blocks(blocks, t(rho), t(guess))
    cold = solver.solve_qp_from_blocks(blocks, t(rho), torch.zeros_like(t(guess)))
    assert float((cold[1] - lam).abs().max()) > 1e-6     # the guess matters
    rel = lambda a, b: float(np.abs(a[0].numpy() - np.asarray(b)).max()
                             / np.abs(np.asarray(b)).max())
    assert rel(dxu, jdxu) < 1e-9 and rel(lam, jlam) < 1e-9
    assert int(stats.pcg_iters[0]) == int(jstats.pcg_iters)
    for name in ("nu_trace", "res_trace"):
        ours, theirs = getattr(stats, name), getattr(jstats, name)
        assert ours.shape == (1, 6)
        assert rel(ours, theirs) < 1e-9, name


@pytest.fixture(scope="module")
def scenarios():
    return F.bench_scenarios(B)


def test_pcg_flagship_solve_matches_jax(scenarios):
    x0s, goals = scenarios
    X0 = np.repeat(x0s[:, :, None], N, axis=2)
    U0 = np.zeros((B, 6, N - 1))
    _, jcost, jsolver = _flagship(N=N, dtype=jnp.float64, use_pallas=False,
                                  use_pallas_fd=False, use_pallas_task=False,
                                  use_pallas_pcg=False, **F.PCG_KNOBS)
    cps = jax.vmap(lambda g: jcost.default_params._replace(xg=g))(
        jnp.asarray(goals))
    ref = jax.jit(jax.vmap(jsolver.solve))(jnp.asarray(X0), jnp.asarray(U0), cps)
    _, cost, solver = F.flagship(N=N, dtype=f64, device="cpu", **F.PCG_KNOBS)
    assert solver.method == "PCG-SS" and solver.options.max_iter_linSys == 40
    res = solver.solve(torch.tensor(X0), torch.tensor(U0),
                       cost.default_params._replace(xg=torch.tensor(goals)))
    np.testing.assert_array_equal(res.exit_sqp.numpy(), np.asarray(ref.exit_sqp))
    np.testing.assert_array_equal(res.sqp_iters.numpy(), np.asarray(ref.sqp_iters))
    assert np.abs(res.U.numpy() - np.asarray(ref.U)).max() < 1e-7
    assert np.abs(res.X.numpy() - np.asarray(ref.X)).max() < 1e-7


def test_solve_with_kernel_pcg_matches_btridiag_pcg():
    """make_sqp(use_kernel_pcg=True) (the fused PCG; its plain version on
    CPU tensors) against the btridiag.pcg path: same exit, controls to
    1e-8 (f64)."""
    opts = SQPOptions(expected_reduction_min=-100.0, max_iter=12,
                      exit_tolerance_linSys=1e-10, max_iter_linSys=60)
    launches = fused_pcg.pcg_fused_kernel.launches
    res = {}
    for flag in (False, True):
        solver = _arm2("PCG-SS", N=16, dt=0.05, options=opts, ref_compat=False,
                       use_kernel_pcg=flag)
        assert solver.kkt.use_kernel_pcg == flag
        res[flag] = solver.solve(torch.zeros((1, 4, 16), dtype=f64),
                                 torch.zeros((1, 2, 15), dtype=f64))
    assert fused_pcg.pcg_fused_kernel.launches == launches  # CPU: no launch
    assert int(res[True].exit_sqp[0]) == int(res[False].exit_sqp[0])
    assert float((res[True].U - res[False].U).abs().max()) < 1e-8


@pytest.mark.parametrize("use_kernel_pcg", [False, True])
@pytest.mark.parametrize("method", ["QP-PCG-J", "QP-PCG-BJ", "QP-PCG-SS"])
def test_make_mpc_pcg_matches_exact_schur(method, use_kernel_pcg):
    """make_mpc('QP-PCG-*') runs the closed loop; with PCG run to an exit
    of 1e-20 it applies the controls of 'QP-S' to 1e-8 (the same SQP on
    Schur solves that agree to ~1e-12), with the same iteration counts."""
    t = lambda a: torch.tensor(a, dtype=f64)
    plant = URDFPlant(robot=serial_arm(2))
    cost = UrdfCost(plant, torch.eye(4, dtype=f64), 100.0 * torch.eye(4, dtype=f64),
                    0.1 * torch.eye(2, dtype=f64), t([0.5, 1.5, 0.0, 0.0]))
    opts = SQPOptions(expected_reduction_min=-100.0, max_iter=3,
                      exit_tolerance_linSys=1e-20, max_iter_linSys=200)
    ctrl = make_mpc(plant, cost, None, 10, 0.05, method=method, options=opts,
                    use_kernel_pcg=use_kernel_pcg)
    assert ctrl.solver.method == method[3:]
    exact = make_mpc(plant, cost, None, 10, 0.05, method="QP-S", options=opts)
    x0 = t([[0.1, -0.2, 0.0, 0.0], [0.0, 0.3, 0.1, 0.0]])
    res, ref = ctrl.run(x0, steps=4), exact.run(x0, steps=4)
    assert res.X_applied.shape == (2, 4, 5) and res.U_applied.shape == (2, 2, 4)
    assert bool(torch.isfinite(res.X_applied).all())
    assert torch.equal(res.iters, ref.iters)
    assert float((res.U_applied - ref.U_applied).abs().max()) < 1e-8


def test_unported_methods_raise():
    """Every method once raised here but "iLQR"; now "N" and "QP-N" build
    (the name is kept) and an invalid method still raises."""
    plant = URDFPlant(robot=serial_arm(2))
    cost = _arm2("S").cost
    assert make_sqp(plant, cost, None, 10, 0.1, method="N").method == "N"
    assert make_mpc(plant, cost, None, 10, 0.1,
                    method="QP-N").solver.method == "N"
    # MPC "iLQR" is ported: it builds an iLQR controller
    assert type(make_mpc(plant, cost, None, 10, 0.1,
                         method="iLQR").solver).__name__ == "ILQRSolver"
    with pytest.raises(ValueError, match="Invalid QP solver"):
        make_sqp(plant, cost, None, 10, 0.1, method="PCG-X")


def test_sqp_kwargs_from_jax_config():
    """A JAX make_sqp(method=..., options=..., use_pallas_pcg=True) maps to
    the port's make_sqp(use_kernel_pcg=True) with equal options."""
    jopts = JaxSQPOptions(expected_reduction_min=-100.0, max_iter_linSys=40,
                          pcg_relative=True, trace_linsys=True)
    kw = sqp_kwargs_from_jax(JaxMethods.PCG_BJ, jopts, use_pallas_pcg=True)
    assert kw["method"] == "PCG-BJ" and kw["use_kernel_pcg"] is True
    assert dataclasses.asdict(kw["options"]) == dataclasses.asdict(jopts)
    solver = make_sqp(URDFPlant(robot=serial_arm(2)), _arm2("S").cost, None,
                      10, 0.1, **kw)
    assert solver.method == "PCG-BJ" and solver.kkt.use_kernel_pcg
    kw = sqp_kwargs_from_jax("S", None, exact_schur="cr")
    assert kw == dict(method="S", options=None, exact_schur="cr",
                      use_kernel_pcg=False)
