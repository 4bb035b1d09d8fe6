"""The port's horizon-sharded operators on P = 4 and P = 8 gloo ranks,
against the JAX package's under shard_map on the 8-device CPU mesh
(tests/conftest.py), f64 unless stated.

One spawn per P (tests/torch_parallel_worker.py "horizon") runs every
check on B = 2 random SPD block-tridiagonal systems drawn as
tests/test_parallel.py:34-39 draws one (N = 16, bs = 4; N = 32 for the
exact solve), and hands its results back as numpy.  Bars: the matvec at
rtol 1e-12 of JAX's sharded matvec; PCG (0, J, BJ, SS; exit 1e-10, 200
iterations) at 1e-6 of the dense solve, with iteration counts within 1
of JAX's sharded PCG (reduction order near the threshold), and each
scenario solved alone within 1e-10 of the batch (the per-scenario freeze;
the batched CPU kernels are not bitwise batch-invariant); the SPIKE exact
solve at 1e-9 (f64) and 5e-5 (f32) of JAX's btd_block_thomas
(tests/test_parallel.py:228, :262).  Replicated results are bit-equal on
every rank, and the all-gather into one tensor equals the list form.
PCG-SS from a warm start (f32, relative exit) at 1e-5 of btridiag.pcg's
on the whole system, and the zero start's bit for bit where the rule
drops the guess.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

from trajoptmpcreference_tpu.ops.btridiag import BlockTridiag as JBlockTridiag
from trajoptmpcreference_tpu.ops.btridiag import btd_block_thomas as jthomas
from trajoptmpcreference_tpu.parallel import make_mesh as jmake_mesh
from trajoptmpcreference_tpu.parallel import sharded_btd_matvec as jmatvec
from trajoptmpcreference_tpu.parallel import sharded_pcg as jpcg
from trajoptmpcreference_tpu.parallel.horizon import ShardedBTD as JShardedBTD
from trajoptmpcreference_tpu.parallel.horizon import shard_btd as jshard_btd
from torch_parallel_worker import spawn

PRECONDS = ["0", "J", "BJ", "SS"]
B, BS = 2, 4


def _random_spd_btd(N, bs, seed=0):
    """tests/test_parallel.py:34-39's system, as numpy."""
    rng = np.random.default_rng(seed)
    diag = rng.standard_normal((N, bs, bs))
    diag = diag @ diag.transpose(0, 2, 1) + 4.0 * bs * np.eye(bs)
    upper = 0.3 * rng.standard_normal((N - 1, bs, bs))
    return diag, upper


def _batch(N, seeds):
    pairs = [_random_spd_btd(N, BS, s) for s in seeds]
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


@pytest.fixture(scope="module")
def inputs():
    diag, upper = _batch(16, (3, 13))
    ediag, eupper = _batch(32, (0, 10))
    rng = np.random.default_rng(4)
    return dict(diag=diag, upper=upper, x=rng.standard_normal((B, 16, BS)),
                b=rng.standard_normal((B, 16, BS)), exact_diag=ediag,
                exact_upper=eupper, exact_b=rng.standard_normal((B, 32, BS)))


@pytest.fixture(scope="module", params=[4, 8])
def ranks(request, inputs, tmp_path_factory):
    return request.param, spawn("horizon", request.param,
                                tmp_path_factory.mktemp(f"horizon{request.param}"),
                                inputs)


@pytest.fixture(scope="module")
def jax_sharded(inputs):
    """JAX's sharded matvec and PCG on the 8-device mesh, per scenario (one
    compile per function and preconditioner)."""
    mesh = jmake_mesh((8,), ("horizon",))
    spec = JP("horizon")

    def on_mesh(f, n_out=1):
        return jax.jit(jax.shard_map(
            f, mesh=mesh, in_specs=(spec,) * 4,
            out_specs=(spec,) * n_out if n_out > 1 else spec, check_vma=False))

    matvec = on_mesh(lambda d, u, p, x: jmatvec(JShardedBTD(d, u, p), x,
                                                "horizon"))
    out = {"matvec": [], **{pre: [] for pre in PRECONDS}}
    for i in range(B):
        sh = jshard_btd(JBlockTridiag(jnp.asarray(inputs["diag"][i]),
                                      jnp.asarray(inputs["upper"][i])), 8)
        out["matvec"].append(np.asarray(matvec(*sh, jnp.asarray(inputs["x"][i]))))
    for pre in PRECONDS:
        def f(d, u, p, b, pre=pre):
            r = jpcg(JShardedBTD(d, u, p), b, "horizon", precond=pre,
                     exit_tolerance=1e-10, max_iter=200)
            return r.x, jnp.broadcast_to(r.iters, (2,))
        run = on_mesh(f, 2)
        for i in range(B):
            sh = jshard_btd(JBlockTridiag(jnp.asarray(inputs["diag"][i]),
                                          jnp.asarray(inputs["upper"][i])), 8)
            _, iters = run(*sh, jnp.asarray(inputs["b"][i]))
            out[pre].append(int(np.asarray(iters)[0]))
    return out


def _replicated(results, key):
    """The value every rank wrote for ``key``, asserting they are equal."""
    for r in results[1:]:
        np.testing.assert_array_equal(r[key], results[0][key], key)
    return results[0][key]


def test_sharded_matvec_matches_jax(ranks, jax_sharded):
    P, results = ranks
    y = _replicated(results, "matvec")
    np.testing.assert_allclose(y, np.stack(jax_sharded["matvec"]), rtol=1e-12)
    # the all-gather into one tensor and the list form agree bit for bit
    np.testing.assert_array_equal(y, _replicated(results, "matvec_list"))


@pytest.mark.parametrize("pre", PRECONDS)
def test_sharded_pcg_matches_dense_and_jax(ranks, inputs, jax_sharded, pre):
    P, results = ranks
    x = _replicated(results, f"pcg_{pre}")
    iters = _replicated(results, f"pcg_{pre}_iters")
    assert _replicated(results, f"pcg_{pre}_converged").all()
    for i in range(B):
        A = np.zeros((16 * BS, 16 * BS))
        for k in range(16):
            A[k * BS:(k + 1) * BS, k * BS:(k + 1) * BS] = inputs["diag"][i, k]
        for k in range(15):
            blk = inputs["upper"][i, k]
            A[k * BS:(k + 1) * BS, (k + 1) * BS:(k + 2) * BS] = blk
            A[(k + 1) * BS:(k + 2) * BS, k * BS:(k + 1) * BS] = blk.T
        exact = np.linalg.solve(A, inputs["b"][i].ravel()).reshape(16, BS)
        np.testing.assert_allclose(x[i], exact, atol=1e-6)
        assert abs(int(iters[i]) - jax_sharded[pre][i]) <= 1, (
            P, pre, i, iters, jax_sharded[pre])
    # each scenario alone: the same iterations, the same iterates
    np.testing.assert_array_equal(_replicated(results, f"pcg_{pre}_alone_iters"),
                                  iters)
    np.testing.assert_allclose(_replicated(results, f"pcg_{pre}_alone"), x,
                               rtol=0, atol=1e-10)


@pytest.mark.parametrize("tag", ["kept", "dropped"])
def test_sharded_pcg_starts_as_btridiag_pcg(ranks, tag):
    """float32 PCG-SS to a relative 1e-6 on the systems times 1e20: from a
    guess the rule keeps, whose residual puts nu past float32's range
    unscaled, a finite answer within 1e-5 of max|x| of btridiag.pcg's on
    the whole system, in iterations within 1 of its; from a guess far
    worse than none, the zero start's answer bit for bit."""
    P, results = ranks
    x = _replicated(results, f"warm_{tag}")
    one = results[0][f"warm_{tag}_one"]
    assert np.isfinite(x).all()
    assert np.abs(x - one).max() <= 1e-5 * np.abs(one).max()
    iters = _replicated(results, f"warm_{tag}_iters")
    assert np.abs(iters - results[0][f"warm_{tag}_one_iters"]).max() <= 1
    if tag == "dropped":
        np.testing.assert_array_equal(x, _replicated(results, "warm_none"))


@pytest.mark.parametrize("tag,dtype,tol", [("f64", jnp.float64, 1e-9),
                                           ("f32", jnp.float32, 5e-5)])
def test_sharded_exact_matches_jax_thomas(ranks, inputs, tag, dtype, tol):
    P, results = ranks
    x = _replicated(results, f"exact_{tag}")
    assert x.dtype == np.dtype(dtype)
    solve = jax.jit(jthomas)
    for i in range(B):
        A = JBlockTridiag(jnp.asarray(inputs["exact_diag"][i], dtype),
                          jnp.asarray(inputs["exact_upper"][i], dtype))
        ref = np.asarray(solve(A, jnp.asarray(inputs["exact_b"][i], dtype)))
        np.testing.assert_allclose(x[i], ref, atol=tol, rtol=tol if
                                   tag == "f32" else 0)
