"""The horizon-sharded SQP and the scenario split on gloo ranks, against
the port's unsharded solver and the JAX package, f64 on the CPU.

The settings are tests/test_parallel.py's (2-link arm reaching
[0.5, 1.5], N = 16, dt = 0.05), in two spawns of
tests/torch_parallel_worker.py "sqp":

* P = 8: PCG-SS at N = 16, from rest and from a perturbed rest, against
  the unsharded PCG-SS (1e-6, equal exit codes and iteration counts:
  :120-147); method S at N = 32 (1e-8: :268-297), and the same sharded
  solve against JAX's unsharded ``make_sqp`` at 1e-8; ``shard_solve`` of
  16 pendulum scenarios over a 'batch' dim against the unsharded batch
  (1e-10: :95-116); every error of ``make_sqp``'s mesh checks and of the
  mesh helpers.
* P = 4: ACTIVE_SET torque limits (+-0.5) by PCG-SS, whose sharded solve
  takes the generic [defect; hard] layout while the unsharded one
  condenses the hard rows (1e-6: :150-178), from rest alone as there:
  from the perturbed rest this solve ends on rho_max, and moving x0 by
  1e-13 relative moves the unsharded solver's own U by 0.23.  Then the
  flagship's cold solve (6-DoF arm, N = 64, f64, B = 2 of bench.py's
  scenarios) by method S through the SPIKE solve.  Its bar is three
  times the gap between the port's own two unsharded exact solves
  (cyclic reduction and block-Thomas), floored at 1e-8: at this cold
  start's conditioning any change of elimination order moves U by ~1e-6
  in f64.

Every replicated result is bit-equal on every rank, so every rank took
the same trip counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from trajoptmpcreference_tpu import (
    SQPOptions as JSQPOptions,
    URDFPlant as JURDFPlant,
    UrdfCost as JUrdfCost,
    make_sqp as jmake_sqp,
    serial_arm as jserial_arm,
)
from trajoptmpcreference_tpu_torch.flagship import bench_scenarios
from torch_parallel_worker import spawn

FIELDS = ("U", "X", "exit_sqp", "sqp_iters", "lam")


def _arm_x0(N):
    rng = np.random.default_rng(0)
    x0 = np.zeros((2, 4, N))
    x0[1] = 0.05 * rng.standard_normal((4, 1))
    return x0


@pytest.fixture(scope="module")
def ranks8(tmp_path_factory):
    rng = np.random.default_rng(0)
    inputs = dict(
        arm_x0=_arm_x0(16),
        pend_x0s=np.tile(rng.standard_normal((16, 2, 1)) * 0.1, (1, 1, 12)),
        pend_goals=np.array([np.pi, 0.0]) + 0.1 * rng.standard_normal((16, 2)))
    return inputs, spawn("sqp", 8, tmp_path_factory.mktemp("sqp8"), inputs)


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    x0s, goals = bench_scenarios(2)
    inputs = dict(arm_x0=_arm_x0(16)[:1], flag_x0s=x0s, flag_goals=goals)
    return inputs, spawn("sqp", 4, tmp_path_factory.mktemp("sqp4"), inputs)


def _sharded(results, key):
    """The sharded solve's fields, asserting every rank holds them bit for
    bit."""
    out = {}
    for field in FIELDS:
        name = f"{key}_{field}"
        for r in results[1:]:
            np.testing.assert_array_equal(r[name], results[0][name], name)
        out[field] = results[0][name]
    return out


def _base(results, key):
    return {f: results[0][f"{key}_base_{f}"]
            for f in ("U", "X", "exit_sqp", "sqp_iters")}


def _assert_solves_match(res, ref, tol, iters=True):
    np.testing.assert_array_equal(res["exit_sqp"], ref["exit_sqp"])
    if iters:
        np.testing.assert_array_equal(res["sqp_iters"], ref["sqp_iters"])
    assert np.abs(res["U"] - ref["U"]).max() < tol
    assert np.abs(res["X"] - ref["X"]).max() < tol


def test_pcg_ss_sharded_matches_unsharded(ranks8):
    _, results = ranks8
    _assert_solves_match(_sharded(results, "pcg_ss"),
                         _base(results, "pcg_ss"), 1e-6)


def test_exact_sharded_matches_unsharded_and_jax(ranks8):
    _, results = ranks8
    res = _sharded(results, "exact")
    _assert_solves_match(res, _base(results, "exact"), 1e-8, iters=False)
    N, dt = 32, 0.05
    plant = JURDFPlant(robot=jserial_arm(2))
    cost = JUrdfCost(plant, jnp.eye(4), 100.0 * jnp.eye(4), 0.1 * jnp.eye(2),
                     jnp.array([0.5, 1.5, 0.0, 0.0]))
    solver = jmake_sqp(plant, cost, None, N, dt, method="S",
                       options=JSQPOptions(expected_reduction_min=-100.0,
                                           max_iter=12))
    ref = jax.jit(solver.solve)(jnp.zeros((4, N)), jnp.zeros((2, N - 1)))
    assert int(res["exit_sqp"][0]) == int(ref.exit_sqp)
    assert np.abs(res["U"][0] - np.asarray(ref.U)).max() < 1e-8


def test_active_set_sharded_matches_condensed_unsharded(ranks4):
    _, results = ranks4
    res, ref = _sharded(results, "active_set"), _base(results, "active_set")
    assert np.abs(res["U"] - ref["U"]).max() < 1e-6
    # the multipliers carry the generic layout's rows: 4 defect rows and
    # an upper and a lower row for each of the 2 torques
    assert res["lam"].shape == (1, 16, 4 + 4)


def test_flagship_cold_solve_sharded(ranks4):
    _, results = ranks4
    res, ref = _sharded(results, "flagship"), _base(results, "flagship")
    floor = np.abs(results[0]["flagship_thomas_U"] - ref["U"]).max()
    bar = max(1e-8, 3 * floor)
    np.testing.assert_array_equal(res["exit_sqp"], ref["exit_sqp"])
    np.testing.assert_array_equal(res["sqp_iters"], ref["sqp_iters"])
    assert np.isfinite(res["U"]).all()
    assert np.abs(res["U"] - ref["U"]).max() < bar, (
        np.abs(res["U"] - ref["U"]).max(), floor)


def test_shard_solve_matches_unsharded_batch(ranks8):
    _, results = ranks8
    for r in results[1:]:
        np.testing.assert_array_equal(r["shard_U"], results[0]["shard_U"])
    U = results[0]["shard_U"]
    assert U.shape == (16, 1, 11)
    np.testing.assert_allclose(U, results[0]["shard_base_U"], rtol=0,
                               atol=1e-10)
    for p, r in enumerate(results):
        np.testing.assert_array_equal(r["local_batch"], [2 * p, 2 * p + 2])


def test_mesh_errors(ranks8):
    _, results = ranks8
    err = {k[6:]: str(v) for k, v in results[0].items()
           if k.startswith("error_")}
    assert "requires a Schur method" in err["method_N"]
    assert "N=12 must divide by the horizon axis size 8" in err["N_divisible"]
    assert "3 local block rows" in err["local_rows"]
    assert err["global_mesh"] == "8 devices not divisible by horizon=3"
    assert err["make_mesh_more"] == "mesh needs 16 devices, have 8"
    assert "leaves 4 of the 8 ranks outside it" in err["make_mesh_fewer"]
    assert err["local_batch"] == "global batch 9 not divisible by 8 processes"


def test_mesh_entry_points_stay_on_the_card(monkeypatch):
    import torch
    from trajoptmpcreference_tpu_torch.parallel import (
        global_mesh,
        initialize,
        make_mesh,
        shard_btd,
    )
    if not torch.cuda.is_available():
        for fn in (global_mesh, lambda: make_mesh((1,)),
                   lambda: initialize(init_method="file:///nonexistent")):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                fn()
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        global_mesh(device_type="tpu")
    with pytest.raises(RuntimeError, match="no process group"):
        make_mesh((1,), device_type="cpu")
    # the errors raised before any collective
    from trajoptmpcreference_tpu_torch import (
        PendulumPlant,
        QuadraticCost,
        make_sqp,
    )
    from trajoptmpcreference_tpu_torch.ops.btridiag import BlockTridiag
    from trajoptmpcreference_tpu_torch.parallel.horizon import (
        sharded_btd_exact,
        sharded_preconditioner,
    )
    eye = torch.eye(2, dtype=torch.float64)
    cost = QuadraticCost(eye, eye, eye[:1, :1], torch.zeros(2, dtype=torch.float64))
    with pytest.raises(ValueError, match="Invalid QP solver"):
        make_sqp(PendulumPlant(), cost, None, 8, 0.1, method="X")
    with pytest.raises(ValueError, match="Invalid exact_schur"):
        make_sqp(PendulumPlant(), cost, None, 8, 0.1, method="S",
                 exact_schur="lu")
    A = BlockTridiag(eye.expand(1, 8, 2, 2), eye.expand(1, 7, 2, 2))
    with pytest.raises(ValueError, match="N=8 must divide by horizon shards 3"):
        shard_btd(A, 3)
    local = shard_btd(A, 4).local(0, 4)
    with pytest.raises(ValueError, match="3 local block rows"):
        sharded_btd_exact(local, torch.zeros(1, 2, 2, dtype=torch.float64),
                          None)
    with pytest.raises(ValueError, match="Invalid preconditioner"):
        sharded_preconditioner(local, "ILU", None)
    # a single process with no coordinator configured: nothing happens
    for var in ("TMR_COORDINATOR", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    initialize(device_type="cpu")
    assert not torch.distributed.is_initialized()
