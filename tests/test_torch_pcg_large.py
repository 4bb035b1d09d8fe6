"""K4 beyond the register variant's shapes, and its storage codes,
compiled as plain C++ and run on the CPU.

kernels/csrc/pcg.cu without __CUDACC__ runs each phase for every thread
of the block in turn (and, built with -DTMR_GROUP_REVERSE_TIDS, in
reverse); in a cluster it runs the ranks of a scenario's cluster one by
one, each as far ahead of the others as the cluster barriers let it (in
reverse, the last rank first).  So g++ checks the cluster variant (a run
of knots per rank, the halos read from the neighbours' memory; one block
where it fits), the global operator (the same cluster of 16 blocks with
its operator converted into a workspace the wrapper allocates, and its
vectors there too past shared memory) and the narrow storage decoders
against ``pcg_fused_plain``:

* shapes over one block's shared memory, at a small batch, in the
  cluster variant: (N, bs) = (200, 12) in f32 (2 blocks; 1e-4 of each
  scenario's scale after fixed iterations, the bar chip_smoke.py holds K4
  to in f32), (24, 24), (64, 24) and (400, 5) in f64 (2, 4 and 2
  blocks, the last at a block size read at run time; 1e-9 after 3
  fixed iterations, before the solve converges, where a halo read before
  its neighbour wrote it, or after it moved on, shows; and 1e-9 with equal
  iteration counts run to convergence: the same loop, sums in another
  order), N = 1,280 at bs = 12 in f32 (8 blocks), whose four vectors
  alone (245,760 bytes) exceed one block's 232,448, and clusters past the
  portable 8 blocks: (1,024, 12) and (200, 24) in f64 (13 and 10 blocks);
* the global operator past 16 blocks' shared memory, N = 1,280 at bs = 12
  in f64 (its vectors in shared memory) and N = 7,800 (its vectors in the
  workspace), and through the entry that runs a given variant at small
  shapes, with the storage codes;
* a build with a planted halo fault (no cluster barrier after SS's s0)
  fails the f64 check at 3 fixed iterations, in the cluster and in the
  global operator;
* bf16 and f16 storage of the blocks and of their inverses in each
  variant, the loop exiting on the true residual r'r when the inverses are
  stored narrow (f64 operands, 1e-9, equal counts);
* the decoders bit pattern by bit pattern against PyTorch's casts, and the
  variant each shape takes at each boundary.
"""

# the planted fault: SS's s0 phase ends on the block's barrier, not the
# cluster's, so its neighbours' t reads their halo before it is written
HALO_PHASE = "TMR_HALO_PHASE(th[TMR_OWN].pre_s0(TMR_TM));"
HALO_FAULT = "TMR_TEAM_PHASE(th[TMR_OWN].pre_s0(TMR_TM));"

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
    """pcg.cu built by g++, in thread order and in reverse, and a copy
    with the planted halo fault (in thread order)."""
    out = tmp_path_factory.mktemp("pcg_large")
    source = (_build.CSRC / "pcg.cu").read_text()
    assert source.count(HALO_PHASE) == 1
    faulty = out / "pcg_halo_fault.cu"
    faulty.write_text(source.replace(HALO_PHASE, HALO_FAULT))
    procs = {}
    for key, flags, src in (
            ("pcg", [], _build.CSRC / "pcg.cu"),
            ("pcg_reversed", ["-DTMR_GROUP_REVERSE_TIDS"],
             _build.CSRC / "pcg.cu"),
            ("pcg_halo_fault", [], faulty)):
        so = out / f"lib{key}.so"
        procs[key] = (subprocess.Popen(
            ["g++", "-x", "c++", "-std=c++17", "-O1", "-shared", "-fPIC",
             *flags, "-o", str(so), str(src)],
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
                     work_elems=lambda N, bs, item:
                     lib.tmr_pcg_variant_work_elems(N, bs, item, variant),
                     variant=variant, **kw)


def _errors(dx, ref):
    """max|d|/max|ref| of each scenario past the first (whose r0 is 0)."""
    return [float((dx[k] - ref[k]).abs().max() / ref[k].abs().max())
            for k in range(1, dx.shape[0])]


def _hold(dx, it, ref, it_ref, bar):
    assert it.tolist() == it_ref.tolist()
    assert torch.equal(dx[0], torch.zeros_like(dx[0]))
    for k, err in enumerate(_errors(dx, ref), start=1):
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
    """The shapes over one block's shared memory, which the first global
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
    """N = 1,280 at bs = 12 in f64, past 16 blocks' shared memory, takes
    the global operator (a cluster of 16, its operator in the workspace,
    its vectors in shared memory); one scenario (and one converged before
    its first iteration) against pcg_fused_plain
    (_hold_fixed_and_converged)."""
    lib, f64 = libs[order], torch.float64
    assert FP.variant(1280, 12, f64, lib.tmr_pcg_variant) == 2
    assert FP.cluster_size(1280, 12, f64, lib.tmr_pcg_cluster_size) == 0
    assert lib.tmr_pcg_work_elems(1280, 12, 8) == 16 * (2 * 80 * 78
                                                       + 81 * 144)
    ops = _problem(2, 1280, 12, seed=7, precond=precond, dtype=f64)
    _hold_fixed_and_converged(lib, ops, precond, f64)


@pytest.mark.parametrize("order", ["pcg", "pcg_reversed"])
@pytest.mark.parametrize("N,bs,C", [(1024, 12, 13), (200, 24, 10)])
@pytest.mark.parametrize("precond", ["BJ", "SS"])
def test_cluster_past_the_portable_size(precond, N, bs, C, order, libs):
    """Clusters of 9-16 blocks (non-portable on the card): (1,024, 12) in
    f64 takes 13 blocks of 79 knots, (200, 24) 10 of 20; against
    pcg_fused_plain in thread-and-rank order and reversed
    (_hold_fixed_and_converged)."""
    lib, f64 = libs[order], torch.float64
    assert FP.variant(N, bs, f64, lib.tmr_pcg_variant) == 3
    assert FP.cluster_size(N, bs, f64, lib.tmr_pcg_cluster_size) == C
    ops = _problem(2, N, bs, seed=N + bs, precond=precond, dtype=f64)
    _hold_fixed_and_converged(lib, ops, precond, f64)


@pytest.mark.parametrize("order", ["pcg", "pcg_reversed"])
@pytest.mark.parametrize("precond", ["BJ", "SS"])
def test_global_operator_vectors_in_the_workspace(precond, order, libs):
    """N = 7,800 at bs = 12 in f64: the global operator's five vectors of
    488 knots a rank (234,240 bytes) exceed one block's shared memory, so
    they join the operator in the workspace and the halos read the
    neighbours' rows there; against pcg_fused_plain
    (_hold_fixed_and_converged)."""
    lib, f64, N = libs[order], torch.float64, 7800
    assert FP.variant(N, 12, f64, lib.tmr_pcg_variant) == 2
    assert lib.tmr_pcg_smem_elems(N, 12, 8) == 128   # the slots alone
    assert lib.tmr_pcg_work_elems(N, 12, 8) == 16 * (
        2 * 488 * 78 + 489 * 144 + 5 * 488 * 12)
    ops = _problem(2, N, 12, seed=11, precond=precond, dtype=f64)
    _hold_fixed_and_converged(lib, ops, precond, f64)


@pytest.mark.parametrize("N,bs,variant", [(200, 12, 3), (1024, 12, 3),
                                          (1280, 12, 2), (7800, 12, 2)])
def test_planted_halo_fault_fails_the_f64_check(N, bs, variant, libs):
    """A build whose SS s0 phase ends on the block's barrier, not the
    cluster's (HALO_FAULT), lets each rank read its neighbour's s0 before
    the neighbour wrote it: after 3 fixed iterations in f64 it misses the
    1e-9 bar that the true build holds (test_global_operator_*, above),
    in clusters of 3 and 13 blocks and in the global operator with its
    vectors in shared memory and in the workspace."""
    lib, f64 = libs["pcg_halo_fault"], torch.float64
    assert FP.variant(N, bs, f64, lib.tmr_pcg_variant) == variant
    ops = _problem(2, N, bs, seed=N + bs, precond="SS", dtype=f64)
    fixed = dict(precond="SS", tol=0.0, max_iter=3, relative=False)
    dx, _ = _host(lib, ops, **fixed)
    ref, _ = FP.pcg_fused_plain(*ops, **fixed)
    assert max(_errors(dx, ref)) > 1e-6


@pytest.mark.parametrize("order", ["pcg", "pcg_reversed"])
@pytest.mark.parametrize("N,bs,variants", [(9, 5, (2, 3)),
                                           (24, 24, (2, 3)),
                                           (30, 12, (0, 2, 3))])
def test_each_variant_by_the_entry_that_names_it(N, bs, variants, order,
                                                 libs):
    """tmr_pcg_f64_as runs the variant it is given: at (9, 5) the global
    operator (9 blocks of one knot) and a cluster of one block (the shared
    operator's shape until the cluster took it); at (24, 24) the global
    operator and a cluster of two; at (30, 12) all three.  Each against
    pcg_fused_plain, SS with bf16 inverses (the r'r exit) and BJ
    (_hold_fixed_and_converged); a variant that cannot take the shape, and
    the retired 1, make the wrapper raise."""
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
    and bf16 inverses with bf16 blocks) in the register variant (7, 12)
    and in clusters of one block (9, 5) and of two (24, 24): the kernel
    reads the narrow values itself, exits on r'r, and matches
    pcg_fused_plain on the same stored operands in f64 with equal
    iteration counts."""
    lib = libs["pcg"]
    f64 = torch.float64
    assert FP.variant(N, bs, f64, lib.tmr_pcg_variant) == {
        (7, 12): 0, (9, 5): 3, (24, 24): 3}[(N, bs)]
    assert FP.cluster_size(N, bs, f64, lib.tmr_pcg_cluster_size) == {
        (7, 12): 1, (9, 5): 1, (24, 24): 2}[(N, bs)]
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
    and 768 from bs = 10, at its built block sizes only; past that the
    cluster, of the fewest blocks C <= 16 each of whose runs of knots (its
    packed blocks, one upper block more, five vectors and 128 reduction
    slots: 64 of the block's, 4 x 16 of the cluster's; one block: four
    vectors, s0 in s's place, and the block's 64 slots) fits 232,448
    bytes; the global operator past 16 blocks (a cluster of 16, its
    operator in the workspace, its vectors in shared memory while they
    fit); the shared memory and the workspace each variant asks for."""
    lib = libs["pcg"]
    var, work = lib.tmr_pcg_variant, lib.tmr_pcg_work_elems
    csize, smem = lib.tmr_pcg_cluster_size, lib.tmr_pcg_smem_elems
    f32, f64 = torch.float32, torch.float64
    slots, limit = 128, 232_448

    def operator_elems(N, bs, C):
        nk, tri = -(-N // C), bs * (bs + 1) // 2
        return 2 * nk * tri + (nk + 1) * bs * bs

    def rank_elems(N, bs, C):
        if C == 1:
            return operator_elems(N, bs, 1) + 4 * N * bs + 64
        return operator_elems(N, bs, C) + 5 * -(-N // C) * bs + slots

    def fewest(N, bs, item):
        return next((C for C in range(1, min(16, N) + 1)
                     if rank_elems(N, bs, C) * item <= limit), 0)

    for bs, rows in ((2, 1024), (8, 1024), (10, 768), (12, 768), (14, 768)):
        last = rows // bs
        for dt in (f32, f64):
            assert FP.variant(last, bs, dt, var) == 0
            assert FP.variant(last + 1, bs, dt, var) == 3
            assert FP.cluster_size(last + 1, bs, dt, csize) == fewest(
                last + 1, bs, dt.itemsize)
    for bs in (1, 3, 5, 12, 16, 24, 30):
        for dt in (f32, f64):
            item = dt.itemsize
            # from the first shape past the register variant: C -> C + 1
            # where the fewest blocks that fit grow, the global operator
            # past 16
            N = next(n for n in range(1, 2000) if FP.variant(n, bs, dt, var))
            C = fewest(N, bs, item)
            seen = set()
            while C:
                assert FP.variant(N, bs, dt, var) == 3, (bs, dt, N)
                assert FP.cluster_size(N, bs, dt, csize) == C
                assert FP.smem_bytes(N, bs, dt, smem) == item * rank_elems(
                    N, bs, C) <= FP.SMEM_LIMIT
                assert work(N, bs, item) == 0
                seen.add(C)
                nxt = fewest(N + 1, bs, item)
                if nxt != C:   # a boundary: C -> C + 1 (or past 16 blocks)
                    assert nxt in (C + 1, 0), (bs, dt, N, C, nxt)
                N, C = N + 1, nxt
            assert FP.variant(N, bs, dt, var) == 2
            assert FP.cluster_size(N, bs, dt, csize) == 0
            vectors = 5 * -(-N // 16) * bs
            assert (vectors + slots) * item <= limit
            assert smem(N, bs, item) == vectors + slots
            assert work(N, bs, item) == 16 * operator_elems(N, bs, 16)
            assert max(seen) == 16, (bs, dt, seen)
            if bs != 12:
                assert seen == set(range(1, 17)), (bs, dt, seen)
    # the shared operator's old range at bs = 12 (N = 65-166 in f32, 65-83
    # in f64) and bs = 24 (up to 45 / 22): one block up to 166 / 82 and 45
    # / 22, then two
    for N, dt in ((166, f32), (82, f64)):
        assert FP.variant(65, 12, dt, var) == 3
        assert FP.cluster_size(65, 12, dt, csize) == 1
        assert FP.cluster_size(N, 12, dt, csize) == 1
        assert FP.cluster_size(N + 1, 12, dt, csize) == 2
    for N, dt in ((45, f32), (22, f64)):
        assert FP.cluster_size(N, 24, dt, csize) == 1
        assert FP.cluster_size(N + 1, 24, dt, csize) == 2
    for N, bs, dt, C in ((64, 24, f32, 2), (256, 12, f32, 2),
                         (1024, 12, f32, 7), (64, 24, f64, 4),
                         (256, 12, f64, 4), (2048, 12, f32, 13),
                         (1024, 12, f64, 13), (128, 12, f32, 1)):
        assert FP.variant(N, bs, dt, var) == 3
        assert FP.cluster_size(N, bs, dt, csize) == C
        FP.check_fits(N, bs, dt, smem)
    for N, dt in ((2560, f32), (1264, f64)):   # the last cluster at bs = 12
        assert FP.cluster_size(N, 12, dt, csize) == 16
        assert FP.variant(N + 1, 12, dt, var) == 2
    for N, dt in ((4096, f32), (1280, f64)):
        assert FP.variant(N, 12, dt, var) == 2
        FP.check_fits(N, 12, dt, smem)
    # past the vectors' room: the vectors in the workspace, the slots alone
    # in shared memory
    for N, dt in ((15456, f32), (7712, f64)):
        item = dt.itemsize
        assert smem(N, 12, item) == 5 * -(-N // 16) * 12 + slots
        assert smem(N + 16, 12, item) == slots
        assert work(N + 16, 12, item) == 16 * (
            operator_elems(N + 16, 12, 16) + 5 * -(-(N + 16) // 16) * 12)
