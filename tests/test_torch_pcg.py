"""Port's preconditioners, batched PCG and fused PCG (K4's plain version)
against the JAX package.

Inputs come from numpy seeds and go through both packages as numpy.
Tolerances: 1e-12 for the preconditioners in f64 (the same block
inverses, two LU libraries); rtol 1e-9 for the PCG iterates, traces and
counts in f64 (the same loop, sums reassociated); 1e-10 between the fused
PCG and ``btridiag.pcg`` in f64 (the fused form reads the diagonal blocks
and their inverses as symmetric from the lower triangle, the full inverse
is symmetric only to rounding); atol 1e-5 against the Pallas kernel run in
interpret mode in f32 (the TPU kernel's own CPU route; f32 rounding of two
LU libraries in the block-Jacobi inverse).
"""

import ctypes
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajoptmpcreference_tpu.ops import btridiag as jbtd
from trajoptmpcreference_tpu.ops.pallas_pcg import make_batched_pcg as jax_batched_pcg
from trajoptmpcreference_tpu_torch.kernels import _build
from trajoptmpcreference_tpu_torch.ops import btridiag as tbtd
from trajoptmpcreference_tpu_torch.ops import fused_pcg as FP

PTYPES = ["0", "J", "BJ", "SS"]


def _systems(B, N, bs, seed, sign=1.0, scales=None):
    """B random SPD (sign -1: negative-definite) block-tridiagonal systems
    (diagonally dominant) and right-hand sides, as numpy."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((B, N, bs, bs))
    diag = M @ np.swapaxes(M, -1, -2) + 4.0 * bs * np.eye(bs)
    upper = 0.3 * rng.standard_normal((B, N - 1, bs, bs))
    b = rng.standard_normal((B, N, bs))
    if scales is not None:
        b = b * np.asarray(scales)[:, None, None]
    return sign * diag, sign * upper, b


def _t(*arrays, dtype=torch.float64):
    return [torch.tensor(np.asarray(a), dtype=dtype) for a in arrays]


def _j(*arrays, dtype=jnp.float64):
    return [jnp.asarray(np.asarray(a), dtype=dtype) for a in arrays]


def test_dense_oracles_match_jax():
    diag, upper, b = _systems(2, 5, 3, seed=0)
    A = tbtd.BlockTridiag(*_t(diag, upper))
    for k in range(2):
        jA = jbtd.BlockTridiag(*_j(diag[k], upper[k]))
        np.testing.assert_array_equal(tbtd.btd_dense(A)[k].numpy(),
                                      np.asarray(jbtd.btd_dense(jA)))
        np.testing.assert_allclose(
            tbtd.btd_solve_dense(A, torch.tensor(b))[k].numpy(),
            np.asarray(jbtd.btd_solve_dense(jA, jnp.asarray(b[k]))), atol=1e-12)


@pytest.mark.parametrize("nblocks", [2, 5, 6, 7])
@pytest.mark.parametrize("ptype", PTYPES)
def test_preconditioner_matches_jax(ptype, nblocks):
    diag, upper, _ = _systems(2, nblocks, 4, seed=nblocks)
    P = tbtd.preconditioner(tbtd.BlockTridiag(*_t(diag, upper)), ptype)
    for k in range(2):
        jP = jbtd.preconditioner(jbtd.BlockTridiag(*_j(diag[k], upper[k])), ptype)
        np.testing.assert_allclose(P.diag[k].numpy(), np.asarray(jP.diag),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(P.upper[k].numpy(), np.asarray(jP.upper),
                                   rtol=0, atol=1e-12)


def test_preconditioner_rejects_unknown_type():
    diag, upper, _ = _systems(1, 3, 2, seed=0)
    with pytest.raises(ValueError, match="Invalid preconditioner"):
        tbtd.preconditioner(tbtd.BlockTridiag(*_t(diag, upper)), "ILU")


@pytest.mark.parametrize("ptype", PTYPES)
def test_batched_pcg_matches_vmapped_jax(ptype):
    """Scenarios with right-hand sides 1e-3..1e3 exit at other iterations;
    x, iters, nu_trace and res_trace equal jax.vmap of the JAX pcg.  The
    traces are held to rtol 1e-9 plus 1e-12 of each scenario's first
    entry: near the exit |nu| is ~1e-10 of nu_0, and its rounding is
    relative to nu_0, not to itself."""
    B, N, bs, tol, max_iter = 3, 7, 4, 1e-10, 60
    diag, upper, b = _systems(B, N, bs, seed=3, scales=[1e-3, 1.0, 1e3])
    A = tbtd.BlockTridiag(*_t(diag, upper))
    res = tbtd.pcg(A, torch.tensor(b), tbtd.preconditioner(A, ptype),
                   exit_tolerance=tol, max_iter=max_iter, trace_residual=True)

    def one(d, u, bb):
        jA = jbtd.BlockTridiag(d, u)
        return jbtd.pcg(jA, bb, jbtd.preconditioner(jA, ptype),
                        exit_tolerance=tol, max_iter=max_iter,
                        trace_residual=True)

    ref = jax.jit(jax.vmap(one))(*_j(diag, upper, b))
    assert len(set(np.asarray(ref.iters).tolist())) > 1     # batchmates differ
    np.testing.assert_array_equal(res.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_array_equal(res.converged.numpy(), np.asarray(ref.converged))
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), rtol=1e-9,
                               atol=1e-12 * np.abs(b).max())
    for name in ("nu_trace", "res_trace"):
        ours, theirs = getattr(res, name).numpy(), np.asarray(getattr(ref, name))
        scale = theirs[:, :1]
        np.testing.assert_allclose(ours / scale, theirs / scale, rtol=1e-9,
                                   atol=1e-12, err_msg=name)


def test_pcg_warm_start_from_solution():
    """guess = x* converges in at most one iteration (ref: PCG.py:33)."""
    diag, upper, b = _systems(2, 6, 4, seed=5)
    A = tbtd.BlockTridiag(*_t(diag, upper))
    P = tbtd.preconditioner(A, "SS")
    bt = torch.tensor(b)
    x_star = tbtd.pcg(A, bt, P, exit_tolerance=1e-24, max_iter=200).x
    res = tbtd.pcg(A, bt, P, guess=x_star, exit_tolerance=1e-10, max_iter=50)
    assert int(res.iters.max()) <= 1
    np.testing.assert_allclose(res.x.numpy(), x_star.numpy(), atol=1e-9)


@pytest.mark.parametrize("relative", [False, True])
def test_pcg_exact_warm_start_takes_no_step(relative):
    """r0 = 0 exactly: nu_0 = 0 meets the threshold (the relative one has a
    1e-30 floor), so there is no pAp = 0 divide and x stays the guess."""
    diag, upper, _ = _systems(2, 5, 3, seed=6)
    A = tbtd.BlockTridiag(*_t(diag, upper))
    x = torch.tensor(np.random.default_rng(6).standard_normal((2, 5, 3)))
    res = tbtd.pcg(A, tbtd.btd_matvec(A, x), tbtd.preconditioner(A, "SS"),
                   guess=x, exit_tolerance=1e-8, max_iter=10, relative=relative)
    assert res.iters.tolist() == [0, 0] and bool(res.converged.all())
    assert torch.equal(res.x, x)


@pytest.mark.parametrize("fused", [False, True])
def test_pcg_batch_invariance(fused):
    """A scenario warm-started at its solution (converged before the first
    iteration) leaves its batchmates' results unchanged, and takes no
    step itself: the batch equals the solo solves (to 1e-12 relative:
    PyTorch's batched CPU matmuls may round differently at another batch
    size)."""
    diag, upper, b = _systems(3, 6, 4, seed=7, scales=[1.0, 10.0, 0.1])
    A = tbtd.BlockTridiag(*_t(diag, upper))
    bt = torch.tensor(b)
    guess = torch.zeros_like(bt)
    guess[1] = torch.tensor(np.linalg.solve(
        tbtd.btd_dense(A)[1].numpy(), b[1].reshape(-1)).reshape(6, 4))
    if fused:
        solve = FP.make_batched_pcg(6, 4, "SS", tol=1e-20, max_iter=100)
        run = lambda idx: solve(tbtd.BlockTridiag(A.diag[idx], A.upper[idx]),
                                bt[idx], guess[idx])
    else:
        P = tbtd.preconditioner(A, "SS")
        run = lambda idx: tuple(tbtd.pcg(
            tbtd.BlockTridiag(A.diag[idx], A.upper[idx]), bt[idx],
            tbtd.BlockTridiag(P.diag[idx], P.upper[idx]), guess=guess[idx],
            exit_tolerance=1e-20, max_iter=100)[:2])
    x, iters = run(slice(None))
    assert int(iters[1]) == 0 and int(iters[0]) > 0
    assert torch.equal(x[1], guess[1])
    for k in range(3):
        xk, ik = run(slice(k, k + 1))
        assert int(ik[0]) == int(iters[k])
        np.testing.assert_allclose(xk[0].numpy(), x[k].numpy(), rtol=0,
                                   atol=1e-12 * float(x[k].abs().max()))


def _fused_operands(diag, upper, b, precond, dtype=torch.float64):
    """Packed operands of the fused PCG for systems (diag, upper) and r0 = b."""
    A = tbtd.BlockTridiag(*_t(diag, upper, dtype=dtype))
    return FP.pack_operands(A, torch.tensor(b, dtype=dtype), precond)


@pytest.mark.parametrize("sign", [1.0, -1.0], ids=["spd", "negdef"])
@pytest.mark.parametrize("relative", [False, True])
@pytest.mark.parametrize("precond", ["J", "BJ", "SS"])
def test_fused_plain_matches_pcg(precond, relative, sign):
    """pcg_fused_plain equals btridiag.pcg (zero start) on SPD and
    negative-definite systems (nu, pAp < 0), N odd, per-scenario counts."""
    B, N, bs = 3, 7, 5
    diag, upper, b = _systems(B, N, bs, seed=11, sign=sign,
                              scales=[1e-2, 1.0, 1e2])
    tol = 1e-16 if relative else 1e-12
    dx, iters = FP.pcg_fused_plain(*_fused_operands(diag, upper, b, precond),
                                   precond=precond, tol=tol, max_iter=100,
                                   relative=relative)
    A = tbtd.BlockTridiag(*_t(diag, upper))
    ref = tbtd.pcg(A, torch.tensor(b), tbtd.preconditioner(A, precond),
                   exit_tolerance=tol, max_iter=100, relative=relative)
    assert iters.dtype == torch.int32
    np.testing.assert_array_equal(iters.numpy(), ref.iters.numpy())
    scale = float(ref.x.abs().amax((-1, -2)).min())
    np.testing.assert_allclose(dx.numpy(), ref.x.numpy(), rtol=0,
                               atol=1e-10 * scale)


@pytest.mark.parametrize("precond", ["BJ", "SS"])
def test_fused_plain_matches_pallas_interpret(precond):
    """The fused PCG (CPU tensors: K4's plain version) against the TPU
    kernel in interpret mode under jax.vmap, N = 8, bs = 4, B = 2, f32.
    The TPU kernel reports its tile's count for every lane; the port
    reports each scenario's own, whose maximum is the tile's."""
    N, bs, B = 8, 4, 2
    diag, upper, b = _systems(B, N, bs, seed=21, scales=[1.0, 30.0])
    guess = 0.1 * np.random.default_rng(22).standard_normal((B, N, bs))
    jsolve = jax_batched_pcg(N, bs, precond=precond, tol=1e-8, max_iter=100,
                             interpret=True)
    jx, jit_ = jax.vmap(lambda d, u, bb, g: jsolve(jbtd.BlockTridiag(d, u), bb, g))(
        *_j(diag, upper, b, guess, dtype=jnp.float32))
    solve = FP.make_batched_pcg(N, bs, precond, tol=1e-8, max_iter=100)
    f32 = torch.float32
    x, iters = solve(tbtd.BlockTridiag(*_t(diag, upper, dtype=f32)),
                     *_t(b, guess, dtype=f32))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=1e-5, rtol=0)
    assert int(iters.max()) == int(np.asarray(jit_)[0])
    assert (np.asarray(jit_) == int(iters.max())).all()


def test_fused_warm_start_converged_takes_no_step():
    """r0 = 0 (a warm start at the solution) exits before the first
    iteration: no pAp = 0 divide, dx = 0, 0 iterations; relative and
    absolute exits alike."""
    diag, upper, _ = _systems(2, 5, 3, seed=4)
    ops = _fused_operands(diag, upper, np.zeros((2, 5, 3)), "SS")
    for relative in (False, True):
        dx, iters = FP.pcg_fused_plain(*ops, precond="SS", tol=0.0,
                                       max_iter=10, relative=relative)
        assert torch.equal(dx, torch.zeros_like(dx))
        assert iters.tolist() == [0, 0]


@pytest.fixture(scope="module")
def pcg_lib(tmp_path_factory):
    """K4's shape entries (pcg.cu ``tmr_pcg_variant``, ``tmr_pcg_smem_elems``)
    from a g++ build of the kernel's source: the wrapper reads them from
    the library."""
    so = tmp_path_factory.mktemp("pcg_host") / "libpcg.so"
    subprocess.run(["g++", "-x", "c++", "-std=c++17", "-O1", "-shared",
                    "-fPIC", "-o", str(so), str(_build.CSRC / "pcg.cu")],
                   check=True)
    lib = ctypes.CDLL(str(so))
    _build.bind_pcg_shapes(lib)
    return lib


def test_fused_shared_memory_limit_raises(pcg_lib):
    """The variant boundaries at bs = 12: the register variant up to 768
    rows of S (N = 64, the flagship, with its block under 10 KB), the
    cluster from N = 65, one block while its knots, four vectors and the
    block's slots fit 232,448 bytes (N = 166 in f32, 82 in f64; the shared
    operator took these shapes up to 166 / 83), then the fewest blocks up
    to 16 (N = 2,560 in f32, 1,264 in f64), the global operator past that;
    check_fits raises at none of them, only past K4's int index."""
    var, smem = pcg_lib.tmr_pcg_variant, pcg_lib.tmr_pcg_smem_elems
    size = pcg_lib.tmr_pcg_cluster_size
    assert FP.smem_bytes(64, 12, torch.float32, smem) < 10_000
    for dtype, n_one, n_cluster in ((torch.float32, 166, 2560),
                                    (torch.float64, 82, 1264)):
        for N, want, C in ((64, 0, 1), (65, 3, 1), (n_one, 3, 1),
                           (n_one + 1, 3, 2), (n_cluster, 3, 16),
                           (n_cluster + 1, 2, 0), (4096, 2, 0)):
            assert FP.variant(N, 12, dtype, var) == want, (dtype, N)
            assert FP.cluster_size(N, 12, dtype, size) == C, (dtype, N)
            FP.check_fits(N, 12, dtype, smem)
        assert FP.smem_bytes(n_one, 12, dtype, smem) <= FP.SMEM_LIMIT
        assert (dtype.itemsize * (2 * (n_one + 1) * 78 + (n_one + 2) * 144
                                  + 4 * 12 * (n_one + 1) + 64)
                > FP.SMEM_LIMIT)
    with pytest.raises(ValueError, match="with an int"):
        FP.check_fits(2 ** 31 // 144 + 1, 12, torch.float32, smem)


def test_make_batched_pcg_rejects_unported_options():
    """An invalid preconditioner raises ValueError; a storage dtype K4
    does not read, or one wider than the operands', TypeError (JAX would
    promote the whole solve to it)."""
    with pytest.raises(ValueError, match="preconditioner"):
        FP.make_batched_pcg(8, 4, "0")
    with pytest.raises(TypeError, match="precond_dtype"):
        FP.make_batched_pcg(8, 4, "SS", precond_dtype=torch.int8)
    with pytest.raises(TypeError, match="operator_dtype"):
        FP.make_batched_pcg(8, 4, "SS", operator_dtype=torch.float8_e4m3fn)
    diag, upper, b = _systems(1, 8, 4, seed=2)
    S = tbtd.BlockTridiag(*_t(diag, upper, dtype=torch.float32))
    bt = torch.tensor(b, dtype=torch.float32)
    for kw in (dict(precond_dtype=torch.float64),
               dict(operator_dtype=torch.float64)):
        solve = FP.make_batched_pcg(8, 4, "SS", **kw)
        with pytest.raises(TypeError, match="wider"):
            solve(S, bt, torch.zeros_like(bt))
