"""Port's SQP solver and MPC loop vs the reference golden and the JAX
package, plus batch invariance and the no-JAX rule.

* arm2_S golden (Euler, ref_compat, sequential line search, block-Thomas):
  controls to 1e-9, as tests/test_sqp_parity.py:70-83.
* The flagship (semi-implicit Euler, task-space cost, method "S" / cyclic
  reduction, parallel 3-rung ladder, Armijo derivative at the base) at
  N = 8, B = 3, f64, against ``jax.vmap`` of __graft_entry__._flagship with
  the Pallas kernels off: one solve (controls to 1e-7) and a 5-step
  run_scheduled episode, 1 cold block-Thomas step + 4 steady steps (states
  and controls to 1e-4).  Iteration counts and exit codes must be equal.
  The tolerances are wide of f64 roundoff because the cold-start Schur
  systems have condition ~1e7-1e9: the ~1e-9 per-solve differences of two
  LU libraries grow through every closed-loop step (both sides take the
  same line-search decisions, which the equal iteration counts check).
"""

import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship, _flagship_mpc
from trajoptmpcreference_tpu.solvers.mpc import run_scheduled as jax_run_scheduled
from trajoptmpcreference_tpu_torch import (
    SQPOptions,
    URDFPlant,
    UrdfCost,
    make_sqp,
    serial_arm,
)
from trajoptmpcreference_tpu_torch import flagship as F
from trajoptmpcreference_tpu_torch.solvers.mpc import MPCController

GOLDEN = pathlib.Path(__file__).parent / "golden"
PACKAGE = pathlib.Path(__file__).parents[1] / "trajoptmpcreference_tpu_torch"
N, B = 8, 3
JAX_KW = dict(N=N, dtype=jnp.float64, use_pallas=False, use_pallas_fd=False,
              use_pallas_task=False)
f64 = torch.float64


def _arm2_solver(options=None):
    t = lambda a: torch.tensor(a, dtype=f64)
    plant = URDFPlant(robot=serial_arm(2))
    cost = UrdfCost(plant, torch.diag(t([1.0, 1.0, 1.0, 1.0])),
                    torch.diag(t([100.0] * 4)), 0.1 * torch.eye(2, dtype=f64),
                    t([0.5, 1.5, 0.0, 0.0]), ref_compat=True)
    # the reference's own working example (ref: examples/twolinks.py:87)
    opts = options or SQPOptions(expected_reduction_min=-100.0)
    return cost, make_sqp(plant, cost, None, 10, 0.1, method="S", options=opts)


def test_arm2_S_matches_reference_golden():
    gold = np.load(GOLDEN / "arm2_S.npz")
    _, solver = _arm2_solver()
    res = solver.solve(torch.zeros((1, 4, 10), dtype=f64),
                       torch.zeros((1, 2, 9), dtype=f64))
    assert int(res.exit_sqp[0]) == int(gold["exit_sqp"])
    assert int(res.exit_soft[0]) == int(gold["exit_soft"])
    assert np.abs(res.U[0].numpy() - gold["u"]).max() < 1e-9
    assert np.abs(res.X[0].numpy() - gold["x"]).max() < 1e-9


@pytest.fixture(scope="module")
def scenarios():
    x0s, goals = F.bench_scenarios(B)
    return x0s, goals


def test_flagship_solve_matches_jax(scenarios):
    x0s, goals = scenarios
    X0 = np.repeat(x0s[:, :, None], N, axis=2)
    U0 = np.zeros((B, 6, N - 1))
    _, jcost, jsolver = _flagship(**JAX_KW)
    cps = jax.vmap(lambda g: jcost.default_params._replace(xg=g))(
        jnp.asarray(goals))
    ref = jax.jit(jax.vmap(jsolver.solve))(jnp.asarray(X0), jnp.asarray(U0), cps)
    _, cost, solver = F.flagship(N=N, dtype=f64, device="cpu")
    res = solver.solve(torch.tensor(X0), torch.tensor(U0),
                       cost.default_params._replace(xg=torch.tensor(goals)))
    np.testing.assert_array_equal(res.exit_sqp.numpy(), np.asarray(ref.exit_sqp))
    np.testing.assert_array_equal(res.sqp_iters.numpy(), np.asarray(ref.sqp_iters))
    assert np.abs(res.U.numpy() - np.asarray(ref.U)).max() < 1e-7
    assert np.abs(res.X.numpy() - np.asarray(ref.X)).max() < 1e-7
    np.testing.assert_allclose(res.J.numpy(), np.asarray(ref.J), rtol=1e-9)


def test_flagship_episode_matches_jax(scenarios):
    x0s, goals = scenarios
    _, jcost, jctrl = _flagship_mpc(**JAX_KW)
    _, _, jcold = _flagship_mpc(**JAX_KW, **F.COLD_KNOBS)
    cps = jax.vmap(lambda g: jcost.default_params._replace(xg=g))(
        jnp.asarray(goals))
    ref = jax.jit(jax.vmap(lambda x0, cp: jax_run_scheduled(
        [(jcold, 1), (jctrl, 4)], x0, cost_params=cp)))(jnp.asarray(x0s), cps)
    _, res = F.run_episode(torch.tensor(x0s), torch.tensor(goals), steps=5,
                           cold_steps=1, N=N)
    assert res.X_applied.shape == (B, 12, 6)
    np.testing.assert_array_equal(res.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_array_equal(res.exit_codes.numpy(),
                                  np.asarray(ref.exit_codes))
    assert np.abs(res.X_applied.numpy() - np.asarray(ref.X_applied)).max() < 1e-4
    assert np.abs(res.U_applied.numpy() - np.asarray(ref.U_applied)).max() < 1e-4
    np.testing.assert_allclose(res.lam_last.numpy(), np.asarray(ref.lam_last),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("config", ["arm2_sequential", "flagship_parallel"])
def test_batch_invariance(config):
    """Scenario 0 solved alone equals scenario 0 solved among batchmates
    that exit at other iterations (the per-scenario freeze, sqp.py:605-615).

    arm2 (sequential ladder): to 1e-12.  Flagship (6 to 8 iterations):
    equal iteration counts and exits, controls to 1e-5 relative to their
    largest — PyTorch's batched CPU kernels round differently at another
    batch size (~1e-14 in the KKT blocks), and the flagship's cold-start
    Schur systems (condition ~1e7-1e9) amplify that over the iterations."""
    rng = np.random.default_rng(1)
    if config == "arm2_sequential":
        cost, solver = _arm2_solver(SQPOptions(expected_reduction_min=-100.0,
                                               max_iter=15))
        goals = np.array([[0.5, 1.5, 0.0, 0.0], [1.2, 0.4, 0.0, 0.0],
                          [-1.0, 1.0, 0.0, 0.0]])
        X0 = np.zeros((3, 4, 10))
        U0 = np.zeros((3, 2, 9))
        tol = 1e-12
    else:
        _, cost, solver = F.flagship(N=N, dtype=f64, max_iter=10, device="cpu")
        x0s, goals = F.bench_scenarios(3, seed=0)
        X0 = np.repeat(x0s[:, :, None], N, axis=2)
        U0 = 0.1 * rng.standard_normal((3, 6, N - 1))
        tol = 1e-5
    t = torch.tensor
    batch = solver.solve(t(X0), t(U0), cost.default_params._replace(xg=t(goals)))
    alone = solver.solve(t(X0[:1]), t(U0[:1]),
                         cost.default_params._replace(xg=t(goals[:1])))
    assert len(set(batch.sqp_iters.tolist())) > 1     # batchmates differ
    assert int(alone.sqp_iters[0]) == int(batch.sqp_iters[0])
    assert int(alone.exit_sqp[0]) == int(batch.exit_sqp[0])
    U = batch.U[0].numpy()
    assert np.abs(alone.U[0].numpy() - U).max() <= tol * np.abs(U).max()


def test_watchdog_coasts_and_cold_resets():
    """With an actuation bound no solve meets, every step applies zero
    control and cold-resets the warm-start carry (mpc.py:157-169)."""
    _, cost, solver = F.flagship(N=N, dtype=f64, device="cpu")
    ctrl = MPCController(solver=solver, sim_plant=solver.plant,
                         watchdog_u_max=1e-9)
    x0s, goals = F.bench_scenarios(2)
    res = ctrl.run(torch.tensor(x0s), 3,
                   cost_params=cost.default_params._replace(xg=torch.tensor(goals)))
    assert torch.equal(res.U_applied, torch.zeros_like(res.U_applied))
    x = torch.tensor(x0s)
    for k in range(3):
        x = solver.plant.step(x, torch.zeros((2, 6), dtype=f64), solver.dt)
        np.testing.assert_allclose(res.X_applied[..., k + 1].numpy(), x.numpy(),
                                   atol=1e-12, rtol=0)
    last = res.X_applied[..., -2:-1].expand(-1, -1, N)
    assert torch.equal(res.X_plan_last, last)
    assert not res.U_plan_last.any() and not res.lam_last.any()


def test_sim_velocity_limit_clamps_applied_states():
    """A joint velocity limit below the arm's speed clamps each simulated
    state's velocities and leaves its positions and the controls as the
    plain step gives them; the flagship sets pi / dt."""
    _, cost, solver = F.flagship(N=N, dtype=f64, device="cpu")
    lim = 1e-2
    ctrl = MPCController(solver=solver, sim_plant=solver.plant, sim_qd_max=lim)
    x0s, goals = F.bench_scenarios(2)
    res = ctrl.run(torch.tensor(x0s), 3,
                   cost_params=cost.default_params._replace(xg=torch.tensor(goals)))
    X, U = res.X_applied, res.U_applied
    assert bool((X[:, 6:, 1:].abs() == lim).any())
    for k in range(3):
        x = solver.plant.step(X[..., k], U[..., k], solver.dt)
        torch.testing.assert_close(X[:, :6, k + 1], x[:, :6], atol=1e-12, rtol=0)
        torch.testing.assert_close(X[:, 6:, k + 1], x[:, 6:].clamp(-lim, lim),
                                   atol=1e-12, rtol=0)
    nan = ctrl.run(torch.full((1, 12), float("nan"), dtype=f64), 1,
                   cost_params=cost.default_params._replace(xg=torch.tensor(goals[:1])))
    assert bool(nan.X_applied[..., -1].isnan().all())
    _, _, flag = F.flagship_mpc(N=N, dtype=f64, device="cpu")
    assert flag.sim_qd_max == F.SIM_QD_MAX == math.pi / solver.dt


def test_port_never_imports_jax():
    """The port and chip_smoke.py import torch and numpy, never jax."""
    sources = list(PACKAGE.rglob("*.py")) + [PACKAGE.parent / "chip_smoke.py"]
    assert len(sources) > 10
    for path in sources:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]):
                assert not words[1].split(".")[0] in ("jax", "jaxlib"), (path, line)
                assert not words[1].startswith("trajoptmpcreference_tpu.") \
                    and words[1] != "trajoptmpcreference_tpu", (path, line)
