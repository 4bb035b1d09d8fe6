"""K4 beyond one block's shared memory, and its storage codes, compiled as
plain C++ and run on the CPU.

kernels/csrc/pcg.cu without __CUDACC__ runs each phase for every thread
of the block in turn (and, built with -DTMR_GROUP_REVERSE_TIDS, in
reverse); in the cluster variant it runs the ranks of a scenario's
cluster one by one, each as far ahead of the others as the cluster
barriers let it (in reverse, the last rank first).  So g++ checks the
cluster variant (a run of knots per rank, the halos read from the
neighbours' memory), the global-operator variant (the packed blocks in
device memory, the vectors in a workspace the wrapper allocates) and the
narrow storage decoders against ``pcg_fused_plain``:

* shapes over one block's shared memory, at a small batch, in the
  cluster variant: (N, bs) = (200, 12) in f32 (2 blocks; 1e-4 of each
  scenario's scale after fixed iterations, the bar chip_smoke.py holds K4
  to in f32), (24, 24), (64, 24) and (400, 5) in f64 (2, 4 and 2
  blocks, the last at a block size read at run time; 1e-9 after 3
  fixed iterations, before the solve converges, where a halo read before
  its neighbour wrote it, or after it moved on, shows; and 1e-9 with equal
  iteration counts run to convergence: the same loop, sums in another
  order), and N = 1,280 at bs = 12 in f32 (8 blocks), whose four vectors
  alone (245,760 bytes) exceed one block's 232,448;
* the global operator past 8 blocks' shared memory, N = 1,280 at bs = 12
  in f64, and through the entry that runs a given variant at small
  shapes, with the storage codes;
* bf16 and f16 storage of the blocks and of their inverses in each
  variant, the loop exiting on the true residual r'r when the inverses are
  stored narrow (f64 operands, 1e-9, equal counts);
* the decoders bit pattern by bit pattern against PyTorch's casts, and the
  variant each shape takes at each boundary.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from trajoptmpcreference_tpu_torch.kernels import _build
from trajoptmpcreference_tpu_torch.ops import btridiag as tbtd
from trajoptmpcreference_tpu_torch.ops import fused_pcg as FP

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no C++ toolchain")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and under several test workers torch's thread pool only contends with
    the other workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """pcg.cu built by g++, in thread order and in reverse."""
    out = tmp_path_factory.mktemp("pcg_large")
    procs = {}
    for key, flags in (("pcg", []), ("pcg_reversed",
                                     ["-DTMR_GROUP_REVERSE_TIDS"])):
        so = out / f"lib{key}.so"
        procs[key] = (subprocess.Popen(
            ["g++", "-x", "c++", "-std=c++17", "-O1", "-shared", "-fPIC",
             *flags, "-o", str(so), str(_build.CSRC / "pcg.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    found = {}
    for key, (proc, so) in procs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, log
        lib = ctypes.CDLL(str(so))
        _build.bind_pcg_shapes(lib)
        for sfx in ("f32", "f64"):
            fn = getattr(lib, f"tmr_pcg_{sfx}")
            fn.argtypes, fn.restype = _build.ARGTYPES["pcg"], ctypes.c_int
        found[key] = lib
    return found


def _problem(B, N, bs, seed, precond, dtype, shift=0.5):
    """Packed operands for B random systems (scenario 1 negative definite,
    scenario 0's r0 exactly zero: converged before the first iteration);
    the diagonal blocks are M M' + shift bs I."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((B, N, bs, bs))
    sign = np.where(np.arange(B) == 1, -1.0, 1.0)[:, None, None, None]
    diag = sign * (M @ np.swapaxes(M, -1, -2) + shift * bs * np.eye(bs))
    upper = sign * 1.2 * rng.standard_normal((B, N - 1, bs, bs)) / bs ** 0.5
    r0 = rng.standard_normal((B, N, bs)) * np.logspace(-1, 1, B)[:, None, None]
    r0[0] = 0.0
    A = tbtd.BlockTridiag(torch.tensor(diag), torch.tensor(upper))
    ops = FP.pack_operands(A, torch.tensor(r0), precond)
    return [t.to(dtype) for t in ops]


def _host(lib, ops, variant=None, **kw):
    """The g++ build on these operands through the wrapper's own call;
    with ``variant``, through the entry that runs that variant."""
    sfx = "f32" if ops[3].dtype == torch.float32 else "f64"
    if variant is None:
        return FP.launch(getattr(lib, f"tmr_pcg_{sfx}"), *ops,
                         work_elems=lib.tmr_pcg_work_elems, **kw)
    return FP.launch(getattr(lib, f"tmr_pcg_{sfx}_as"), *ops,
                     work_elems=lambda N, bs, _item:
                     lib.tmr_pcg_variant_work_elems(N, bs, variant),
                     variant=variant, **kw)


def _hold(dx, it, ref, it_ref, bar):
    assert it.tolist() == it_ref.tolist()
    assert torch.equal(dx[0], torch.zeros_like(dx[0]))
    for k in range(1, dx.shape[0]):
        err = float((dx[k] - ref[k]).abs().max() / ref[k].abs().max())
        assert err < bar, (k, err)


def _hold_fixed_and_converged(lib, ops, precond, dtype, variant=None):
    """Fixed iterations (tol = 0) against pcg_fused_plain: 12 in f32 under
    1e-4, 3 in f64 under 1e-9 (before the solve converges); f64 also run
    to convergence (relative 1e-20: SS takes 5 iterations, BJ more) with
    equal counts."""
    f32 = dtype == torch.float32
    fixed = dict(precond=precond, tol=0.0, max_iter=12 if f32 else 3,
                 relative=False)
    bar = 1e-4 if f32 else 1e-9
    _hold(*_host(lib, ops, variant, **fixed),
          *FP.pcg_fused_plain(*ops, **fixed), bar)
    if not f32:
        conv = dict(precond=precond, tol=1e-20, max_iter=200, relative=True)
        dx, it = _host(lib, ops, variant, **conv)
        assert int(it[1:].min()) >= 4
        _hold(dx, it, *FP.pcg_fused_plain(*ops, **conv), bar)


@pytest.mark.parametrize("order", ["pcg", "pcg_reversed"])
@pytest.mark.parametrize("N,bs,dtype", [(200, 12, torch.float32),
                                        (24, 24, torch.float64),
                                        (1280, 12, torch.float32),
                                        (64, 24, torch.float64),
                                        (400, 5, torch.float64)])
@pytest.mark.parametrize("precond", ["BJ", "SS"])
def test_global_operator_matches_plain(precond, N, bs, dtype, order, libs):
    """The shapes over one block's shared memory, which the global
    operator took until the cluster variant took them (2, 2, 8, 4 and 2
    blocks a scenario; bs = 12 and 24 built in, bs = 5 read at run time),
    against pcg_fused_plain in thread-and-rank order and reversed
    (_hold_fixed_and_converged)."""
    lib = libs[order]
    assert FP.variant(N, bs, dtype, lib.tmr_pcg_variant) == 3
    assert FP.cluster_size(N, bs, dtype, lib.tmr_pcg_cluster_size) == {
        200: 2, 24: 2, 1280: 8, 64: 4, 400: 2}[N]
    if N * bs > 4096:   # the vectors alone: over one block's shared memory
        assert 4 * N * bs * dtype.itemsize > FP.SMEM_LIMIT
    B = 3 if N * bs < 4096 else 2
    ops = _problem(B, N, bs, seed=N + bs, precond=precond, dtype=dtype)
    _hold_fixed_and_converged(lib, ops, precond, dtype)


@pytest.mark.parametrize("order", ["pcg", "pcg_reversed"])
@pytest.mark.parametrize("precond", ["BJ", "SS"])
def test_global_operator_past_eight_blocks(precond, order, libs):
    """N = 1,280 at bs = 12 in f64, past 8 blocks' shared memory, takes
    the global operator; one scenario (and one converged before its first
    iteration) against pcg_fused_plain (_hold_fixed_and_converged)."""
    lib, f64 = libs[order], torch.float64
    assert FP.variant(1280, 12, f64, lib.tmr_pcg_variant) == 2
    assert FP.cluster_size(1280, 12, f64, lib.tmr_pcg_cluster_size) == 0
    ops = _problem(2, 1280, 12, seed=7, precond=precond, dtype=f64)
    _hold_fixed_and_converged(lib, ops, precond, f64)


@pytest.mark.parametrize("order", ["pcg", "pcg_reversed"])
@pytest.mark.parametrize("N,bs,variants", [(9, 5, (1, 2, 3)),
                                           (24, 24, (2, 3)),
                                           (30, 12, (0, 1, 2, 3))])
def test_each_variant_by_the_entry_that_names_it(N, bs, variants, order,
                                                 libs):
    """tmr_pcg_f64_as runs the variant it is given: at (9, 5) the shared
    operator, the global operator and a cluster of one block; at (24, 24)
    the global operator and a cluster of two; at (30, 12) all four.  Each
    against pcg_fused_plain, SS with bf16 inverses (the r'r exit) and BJ
    (_hold_fixed_and_converged); a variant that cannot take the shape
    makes the wrapper raise."""
    lib, f64 = libs[order], torch.float64
    for v in variants:
        for precond, narrow in (("SS", torch.bfloat16), ("BJ", None)):
            diag_p, upper, pdiag_p, r0 = _problem(3, N, bs, seed=N + v,
                                                  precond=precond, dtype=f64)
            if narrow is not None:
                pdiag_p = pdiag_p.to(narrow)
            _hold_fixed_and_converged(lib, (diag_p, upper, pdiag_p, r0),
                                      precond, f64, variant=v)
    ops = _problem(2, N, bs, seed=1, precond="SS", dtype=f64)
    for v in sorted({0, 1, 2, 3, 4} - set(variants)):
        with pytest.raises(RuntimeError, match="return code -1"):
            _host(lib, ops, v, precond="SS", tol=0.0, max_iter=2,
                  relative=False)


@pytest.mark.parametrize("N,bs", [(7, 12), (9, 5), (24, 24)])
@pytest.mark.parametrize("storage", ["bf16", "f16", "bf16 operator",
                                     "f32"])
def test_storage_codes_match_plain(storage, N, bs, libs):
    """Narrow storage of the inverses (bf16, f16; f32 under f64 operands;
    and bf16 inverses with bf16 blocks) in the register (7, 12), shared
    (9, 5) and cluster (24, 24) variants: the kernel reads the narrow
    values itself, exits on r'r, and matches pcg_fused_plain on the same
    stored operands in f64 with equal iteration counts."""
    lib = libs["pcg"]
    f64 = torch.float64
    assert FP.variant(N, bs, f64, lib.tmr_pcg_variant) == {
        (7, 12): 0, (9, 5): 1, (24, 24): 3}[(N, bs)]
    narrow = {"bf16": torch.bfloat16, "f16": torch.float16,
              "bf16 operator": torch.bfloat16, "f32": torch.float32}[storage]
    diag_p, upper, pdiag_p, r0 = _problem(3, N, bs, seed=bs, precond="SS",
                                          dtype=f64)
    pdiag_p = pdiag_p.to(narrow)
    if storage == "bf16 operator":
        diag_p = diag_p.to(narrow)
    ops = (diag_p, upper, pdiag_p, r0)
    kw = dict(precond="SS", tol=1e-20, max_iter=300, relative=True)
    dx, it = _host(lib, ops, **kw)
    ref, it_ref = FP.pcg_fused_plain(*ops, **kw)
    _hold(dx, it, ref, it_ref, 1e-9)
    # the true-residual exit: r'r under tol r0'r0 where the loop stopped
    S = tbtd.BlockTridiag(FP._unpack_sym(diag_p.double(), bs),
                          upper[:, :-1])
    for k in range(1, 3):
        if int(it[k]) < kw["max_iter"]:
            res = r0[k] - tbtd.btd_matvec(
                tbtd.BlockTridiag(S.diag[k], S.upper[k]), dx[k])
            assert float((res * res).sum()) <= 1.01e-20 * float(
                (r0[k] * r0[k]).sum())


def test_storage_decoders_every_bit_pattern(libs):
    """pcg.cu's bf16 and f16 decoders, every one of the 65,536 patterns,
    against PyTorch's casts to f64 (NaNs as NaNs); f32 and the operands'
    own type pass through."""
    lib = libs["pcg"]
    bits = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int16)
    for code, dtype in ((2, torch.bfloat16), (3, torch.float16)):
        vals = bits.view(dtype)
        got = torch.tensor([lib.tmr_pcg_stored(vals.data_ptr(), i, code)
                            for i in range(vals.numel())], dtype=torch.float64)
        want = vals.double()
        nan = torch.isnan(want)
        assert torch.equal(torch.isnan(got), nan)
        assert torch.equal(got[~nan], want[~nan])
    x = torch.tensor([1.0 / 3.0, -2.5e-30, 7e37])
    for code, t in ((1, x), (0, x.double())):
        got = [lib.tmr_pcg_stored(t.data_ptr(), i, code) for i in range(3)]
        assert got == t.double().tolist()


def test_variant_at_each_boundary(libs):
    """tmr_pcg_variant: the register variant up to 1,024 rows at bs <= 8
    and 768 from bs = 10, at its built block sizes only; the shared
    operator while its system, four vectors and 64 reduction slots fit
    232,448 bytes; past that the cluster, of the fewest blocks C <= 8 each
    of whose runs of knots (its packed blocks, one upper block more, five
    vectors and 96 reduction slots) fits; the global operator past 8
    blocks; the shared memory and the workspace each variant asks for."""
    lib = libs["pcg"]
    var, work = lib.tmr_pcg_variant, lib.tmr_pcg_work_elems
    csize, smem = lib.tmr_pcg_cluster_size, lib.tmr_pcg_smem_elems
    f32, f64 = torch.float32, torch.float64

    def shared_fits(N, bs, item):
        tri = bs * (bs + 1) // 2
        return (2 * N * tri + N * bs * bs + 4 * N * bs + 64) * item <= 232_448

    def rank_elems(N, bs, C):
        nk, tri = -(-N // C), bs * (bs + 1) // 2
        return 2 * nk * tri + (nk + 1) * bs * bs + 5 * nk * bs + 96

    def fewest(N, bs, item):
        return next((C for C in range(1, 9)
                     if rank_elems(N, bs, C) * item <= 232_448), 0)

    for bs, rows in ((2, 1024), (8, 1024), (10, 768), (12, 768), (14, 768)):
        last = rows // bs
        for dt in (f32, f64):
            assert FP.variant(last, bs, dt, var) == 0
            assert FP.variant(last + 1, bs, dt, var) == (
                1 if shared_fits(last + 1, bs, dt.itemsize) else 3)
    for bs in (1, 3, 5, 12, 16, 24, 30):
        for dt in (f32, f64):
            item = dt.itemsize
            n_max = 1
            while shared_fits(n_max + 1, bs, item):
                n_max += 1
            assert FP.variant(n_max, bs, dt, var) == 1
            assert work(n_max, bs, item) == 0
            # the cluster from one block row more: C -> C + 1 where the
            # fewest blocks that fit grow, the global operator past 8
            N, C = n_max + 1, fewest(n_max + 1, bs, item)
            assert C >= 2
            seen = set()
            while C:
                assert FP.variant(N, bs, dt, var) == 3, (bs, dt, N)
                assert FP.cluster_size(N, bs, dt, csize) == C
                assert FP.smem_bytes(N, bs, dt, smem) == item * rank_elems(
                    N, bs, C) <= FP.SMEM_LIMIT
                assert work(N, bs, item) == 0
                nxt = fewest(N + 1, bs, item)
                if nxt != C:   # a boundary: C -> C + 1 (or past 8 blocks)
                    assert nxt in (C + 1, 0), (bs, dt, N, C, nxt)
                    seen.add(C)
                N, C = N + 1, nxt
            assert FP.variant(N, bs, dt, var) == 2
            assert FP.cluster_size(N, bs, dt, csize) == 0
            assert work(N, bs, item) == 4 * N * bs
            assert seen and max(seen) == 8, (bs, dt, seen)
    for N, dt in ((166, f32), (83, f64)):
        assert FP.variant(N, 12, dt, var) == 1
        assert FP.variant(N + 1, 12, dt, var) == 3
        assert FP.cluster_size(N + 1, 12, dt, csize) == 2
    assert FP.variant(45, 24, f32, var) == 1 and FP.variant(46, 24, f32, var) == 3
    assert FP.variant(22, 24, f64, var) == 1 and FP.variant(23, 24, f64, var) == 3
    for N, bs, dt, C in ((64, 24, f32, 2), (256, 12, f32, 2),
                         (1024, 12, f32, 7), (64, 24, f64, 4),
                         (256, 12, f64, 4)):
        assert FP.variant(N, bs, dt, var) == 3
        assert FP.cluster_size(N, bs, dt, csize) == C
        FP.check_fits(N, bs, dt, smem)
    for N, dt in ((1280, f32), (640, f64)):   # the last cluster at bs = 12
        assert FP.variant(N, 12, dt, var) == 3
        assert FP.variant(N + 1, 12, dt, var) == 2
    for N, dt in ((2048, f32), (1280, f64)):
        assert FP.variant(N, 12, dt, var) == 2
        FP.check_fits(N, 12, dt, smem)
