"""Batched block-tridiagonal PCG as one fused kernel (K4).

Counterpart of trajoptmpcreference_tpu/ops/pallas_pcg.py.  The whole
Krylov loop of a scenario runs inside one CUDA thread block
(kernels/csrc/pcg.cu), where the XLA-style ``btridiag.pcg`` launches a
dozen small ops per iteration.  Three variants (``variant``): two rows of
the Schur system per thread with their rows of the operator and the
preconditioner in registers, for the plants' shapes; for every other
shape, a thread-block cluster of up to 16 blocks per scenario (one block
where it fits), each holding a run of knots, the operator spread over the
cluster's shared memory (``cluster_size``); past 16 blocks' shared memory,
a cluster of 16 whose operator is written once, converted and laid out
for coalesced reads, into a workspace in device memory.

The packed diagonal blocks and their inverses may be stored narrower than
the operands (``make_batched_pcg``'s ``operator_dtype`` and
``precond_dtype``: bfloat16, float16, float32 under float64); K4 reads
them so and computes in the operands' dtype.

Layout, batch-major so one block reads one contiguous scenario:

  diag_p, pdiag_p  (B, N, T)       packed lower triangles, T = bs(bs+1)/2
  upper            (B, N, bs, bs)  upper[:, k] = S[k, k+1], zero at k = N-1
  r0               (B, N, bs)      initial residual; the solve starts at 0

The diagonal blocks and their inverses are symmetric (PCG needs a
symmetric operator) and are read from their lower triangle, as the TPU
kernel's packed storage reads them.  ``pcg_fused_plain`` is the plain
PyTorch version of the kernel: the same packed operands and the same loop,
so the two agree to rounding.  It differs from ``btridiag.pcg`` with a full
(not symmetrized) block inverse at the ~1e-7 level in f32.

Iteration counts: the TPU kernel reports its 128-lane tile's count for
every lane; K4 and its plain version report each scenario's own count
(the meaning of ``btridiag.pcg``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from trajoptmpcreference_tpu_torch.ops.btridiag import (
    BlockTridiag,
    _bmv,
    _bmv_T,
    _dot,
    _inv_blocks,
    btd_matvec,
)
from trajoptmpcreference_tpu_torch.ops.lanes import SMEM_LIMIT, on_card

PRECONDS = ("J", "BJ", "SS")


def _tri_indices(bs: int):
    """Row/col index arrays of the packed lower triangle, and the
    (i, j) -> packed-position table (pallas_pcg.py:50)."""
    rows, cols = np.tril_indices(bs)
    pos = {(int(i), int(j)): k for k, (i, j) in enumerate(zip(rows, cols))}
    return rows, cols, pos


def _pack_sym(blocks, rows, cols):
    """(..., bs, bs) symmetric -> (..., T) packed lower triangle."""
    return blocks[..., rows, cols]


def _unpack_sym(packed, bs: int):
    """(..., T) packed lower triangle -> (..., bs, bs), symmetric."""
    _, _, pos = _tri_indices(bs)
    idx = [pos[(max(i, j), min(i, j))] for i in range(bs) for j in range(bs)]
    idx = torch.tensor(idx, device=packed.device)
    return packed[..., idx].reshape(packed.shape[:-1] + (bs, bs))


# the storage of the packed diagonal blocks and their inverses, as pcg.cu
# reads it (Storage): a dtype the same as the operands' is code 0
STORAGE = {torch.float32: 1, torch.bfloat16: 2, torch.float16: 3}
# K4's variants by number (pcg.cu ``variant``; 1, the shared operator, is
# retired)
VARIANTS = {0: "registers", 2: "global operator", 3: "cluster"}
# K4 indexes a scenario's upper blocks with an int
INDEX_LIMIT = 2 ** 31 - 1


def _pcg_library():
    from trajoptmpcreference_tpu_torch.kernels import _build
    return _build.library("pcg")


def variant(N: int, bs: int, dtype: torch.dtype, fn=None) -> int:
    """The K4 variant that takes (N, bs) in ``dtype`` (pcg.cu
    ``tmr_pcg_variant``, from the built library unless another build's
    entry is given): 0 registers, 3 cluster, 2 global operator (a
    cluster of 16 with its operator in device memory)."""
    fn = fn or _pcg_library().tmr_pcg_variant
    return int(fn(N, bs, dtype.itemsize))


def cluster_size(N: int, bs: int, dtype: torch.dtype, fn=None) -> int:
    """The blocks of the cluster variant's cluster at (N, bs) in ``dtype``
    (pcg.cu ``tmr_pcg_cluster_size``): the smallest cluster whose blocks
    each hold their run of knots, 1 to 16, 0 past 16 blocks."""
    fn = fn or _pcg_library().tmr_pcg_cluster_size
    return int(fn(N, bs, dtype.itemsize))


def smem_bytes(N: int, bs: int, dtype: torch.dtype, smem_elems=None) -> int:
    """Dynamic shared memory of K4's block for one scenario: the kernel's
    own formula, ``tmr_pcg_smem_elems`` (values per block, for the variant
    that takes (N, bs) in ``dtype``), from the built library unless another
    build's entry is given."""
    smem_elems = smem_elems or _pcg_library().tmr_pcg_smem_elems
    return dtype.itemsize * int(smem_elems(N, bs, dtype.itemsize))


def check_fits(N: int, bs: int, dtype: torch.dtype, smem_elems=None) -> None:
    """Raise ValueError for a shape K4 cannot address: a scenario's upper
    blocks past its int index.  Every other shape takes a variant (the
    cluster past the register variant's shapes, the global operator past
    16 blocks' shared memory), whose block this checks against the
    limit."""
    if N * bs * bs > INDEX_LIMIT:
        raise ValueError(
            f"K4 indexes a scenario's upper blocks with an int: N={N}, "
            f"bs={bs} has {N * bs * bs} values, over {INDEX_LIMIT}")
    need = smem_bytes(N, bs, dtype, smem_elems)
    if need > SMEM_LIMIT:
        raise ValueError(f"K4's block for N={N}, bs={bs} in {dtype} needs "
                         f"{need} bytes, over the {SMEM_LIMIT}-byte limit")


def _precond_code(precond: str) -> int:
    if precond not in PRECONDS:
        raise ValueError(f"Invalid fused-PCG preconditioner {precond!r}; "
                         f"options are {PRECONDS}")
    return int(precond == "SS")


def storage_code(dtype: torch.dtype, operands: torch.dtype) -> int:
    """pcg.cu's code for packed blocks stored in ``dtype`` under operands
    of ``operands``: 0 for their own type; TypeError for a type K4 does not
    read, or one wider than the operands' (JAX would promote the whole
    solve to it)."""
    if dtype == operands:
        return 0
    if dtype not in STORAGE and dtype != torch.float64:
        raise TypeError(f"K4 block storage must be float64, float32, "
                        f"bfloat16 or float16, got {dtype}")
    if dtype.itemsize > operands.itemsize:
        raise TypeError(f"K4 block storage {dtype} is wider than the "
                        f"operands' {operands}")
    return STORAGE[dtype]


def pcg_fused_plain(diag_p, upper, pdiag_p, r0, *, precond: str, tol: float,
                    max_iter: int, relative: bool):
    """Plain version of K4 (pallas_pcg.py:123-206): solves S dx = r0 from
    dx = 0 for every scenario.  Returns (dx (B, N, bs), iters (B,) int32).

    diag_p and pdiag_p may be stored narrower than r0 (storage_code); each
    is cast to r0's dtype where it is used.  apply_P is s = Dinv r, plus for
    SS s - Dinv (U s_{k+1} + U^T s_{k-1}); the exit metric is nu = r's, or
    the true residual r'r when pdiag_p's dtype is not r0's (:335-336); the
    threshold is max(tol |m_0|, 1e-30) when relative, else tol; a scenario
    that is done takes no step and keeps nu and p.  One host check per
    iteration ends the loop once every scenario is done."""
    ss = _precond_code(precond) == 1
    for t in (diag_p, pdiag_p):
        storage_code(t.dtype, r0.dtype)
    true_exit = pdiag_p.dtype != r0.dtype
    bs = r0.shape[-1]
    D = _unpack_sym(diag_p.to(r0.dtype), bs)
    P = _unpack_sym(pdiag_p.to(r0.dtype), bs)
    U = upper[:, :-1]

    def off(v):
        """U_k v_{k+1} + U_{k-1}^T v_{k-1}: the off-diagonal blocks of S."""
        y = torch.zeros_like(v)
        y[:, :-1] += _bmv(U, v[:, 1:])
        y[:, 1:] += _bmv_T(U, v[:, :-1])
        return y

    def matvec(v):
        return _bmv(D, v) + off(v)

    def apply_P(r):
        s = _bmv(P, r)
        return s - _bmv(P, off(s)) if ss else s

    x = torch.zeros_like(r0)
    r = r0
    s = apply_P(r)
    p = s
    nu = _dot(r, s)
    m = _dot(r, r) if true_exit else nu
    thr = ((tol * m.abs()).clamp(min=1e-30) if relative
           else torch.full_like(m, tol))
    done = m.abs() <= thr
    it = torch.zeros(nu.shape, dtype=torch.int32, device=r0.device)
    for _ in range(max_iter):
        if bool(done.all()):
            break
        Ap = matvec(p)
        pAp = _dot(p, Ap)
        alpha = nu / torch.where(pAp != 0, pAp, torch.ones_like(pAp))
        keep = done[:, None, None]
        a = alpha[:, None, None]
        x = torch.where(keep, x, x + a * p)
        r = torch.where(keep, r, r - a * Ap)
        s = apply_P(r)
        nu_new = torch.where(done, nu, _dot(r, s))
        m = _dot(r, r) if true_exit else nu_new
        it = torch.where(done, it, it + 1)
        done = done | (m.abs() <= thr)
        p = torch.where(done[:, None, None], p,
                        s + (nu_new / nu)[:, None, None] * p)
        nu = nu_new
    return x, it


def _check_operands(diag_p, upper, pdiag_p, r0):
    B, N, bs = r0.shape
    tri = bs * (bs + 1) // 2
    shapes = {"diag_p": (diag_p, (B, N, tri)), "upper": (upper, (B, N, bs, bs)),
              "pdiag_p": (pdiag_p, (B, N, tri)), "r0": (r0, (B, N, bs))}
    if r0.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"K4 dtype must be float32 or float64, got {r0.dtype}")
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"K4 operand {name}: expected {shape}, got "
                             f"{tuple(t.shape)}")
        if t.device != r0.device or not on_card(t):
            raise ValueError("K4 operands must all lie on one CUDA device")
        if name in ("upper", "r0") and t.dtype != r0.dtype:
            raise TypeError("K4's upper blocks and r0 must share one dtype")
        if not t.is_contiguous():
            raise ValueError("K4 operands must be contiguous")
    for t in (diag_p, pdiag_p):
        storage_code(t.dtype, r0.dtype)
    check_fits(N, bs, r0.dtype)
    return B, N, bs


def launch(fn, diag_p, upper, pdiag_p, r0, *, precond: str, tol: float,
           max_iter: int, relative: bool, work_elems, stream=None,
           variant=None):
    """Call a ``tmr_pcg_<f32|f64>`` entry (the card's library, or a g++
    build of pcg.cu on CPU tensors) on these operands: allocates dx, the
    iteration counts and the global operator's workspace (``work_elems``:
    the build's ``tmr_pcg_work_elems``), and raises on a nonzero return
    (a CUDA error, a refused launch, -1 for a shape the entry refuses, -2
    for a cluster the card cannot hold).
    With ``variant``, ``fn`` is a ``tmr_pcg_<f32|f64>_as`` entry, called
    with it last.  Returns (dx, iters)."""
    B, N, bs = r0.shape
    dcode = storage_code(diag_p.dtype, r0.dtype)
    pcode = storage_code(pdiag_p.dtype, r0.dtype)
    dx = torch.empty_like(r0)
    iters = torch.empty((B,), dtype=torch.int32, device=r0.device)
    per = int(work_elems(N, bs, r0.element_size()))
    work = torch.empty((B * per,), dtype=r0.dtype, device=r0.device)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr() if t.numel() else None)
    extra = () if variant is None else (int(variant),)
    rc = fn(ptr(diag_p), ptr(upper), ptr(pdiag_p), ptr(r0), ptr(dx),
            ptr(iters), ptr(work), B, N, bs, dcode, pcode,
            _precond_code(precond), int(relative), max_iter, float(tol),
            ctypes.c_void_p(stream), *extra)
    if rc != 0:
        why = {-1: " (a shape or variant K4 does not take)",
               -2: " (the card holds no cluster of this shape)"}.get(rc, "")
        raise RuntimeError(f"kernel pcg failed: return code {rc}{why}")
    return dx, iters


def pcg_fused_kernel(diag_p, upper, pdiag_p, r0, *, precond: str, tol: float,
                     max_iter: int, relative: bool, variant=None):
    """K4 on the card: one thread block (or cluster) per scenario; same
    arguments and results as ``pcg_fused_plain``.  The packed blocks go to
    the kernel in their storage dtype.  ``variant`` runs that variant in
    place of the one the shape takes (raising if it cannot take the
    shape): chip_smoke.py times one variant beside another with it; the
    solve path never passes it."""
    _precond_code(precond)
    B, N, bs = _check_operands(diag_p, upper, pdiag_p, r0)
    if not B:
        return (torch.empty_like(r0),
                torch.empty((0,), dtype=torch.int32, device=r0.device))
    lib = _pcg_library()
    suffix = "f32" if r0.dtype == torch.float32 else "f64"
    if variant is None:
        fn, work = getattr(lib, f"tmr_pcg_{suffix}"), lib.tmr_pcg_work_elems
    else:
        fn = getattr(lib, f"tmr_pcg_{suffix}_as")
        work = (lambda N, bs, item:
                lib.tmr_pcg_variant_work_elems(N, bs, item, variant))
    dx, iters = launch(fn, diag_p, upper, pdiag_p, r0, precond=precond,
                       tol=tol, max_iter=max_iter, relative=relative,
                       work_elems=work, variant=variant,
                       stream=torch.cuda.current_stream(r0.device).cuda_stream)
    pcg_fused_kernel.launches += 1
    return dx, iters


pcg_fused_kernel.launches = 0


def pack_operands(S: BlockTridiag, r0, precond: str):
    """K4's operands (diag_p, upper, pdiag_p, r0) for the systems S with
    initial residuals r0, leading axes flattened to one batch axis: the
    block-Jacobi inverse (for J, diag(1/d)) packed beside the packed
    diagonal, and the upper blocks padded with a zero block at N-1."""
    if precond == "J":
        pdiag = torch.diag_embed(1.0 / S.diag.diagonal(0, -2, -1))
    else:   # BJ and SS both need the block-diagonal inverse
        pdiag = _inv_blocks(S.diag, spd=True)
    rows, cols, _ = _tri_indices(S.bs)
    upper = torch.cat([S.upper, torch.zeros_like(S.diag[..., :1, :, :])],
                      dim=-3)
    flat = lambda t, k: t.reshape((-1,) + t.shape[t.dim() - k:]).contiguous()
    return (flat(_pack_sym(S.diag, rows, cols), 2), flat(upper, 3),
            flat(_pack_sym(pdiag, rows, cols), 2), flat(r0, 2))


def make_batched_pcg(N: int, bs: int, precond: str = "SS", tol: float = 1e-4,
                     max_iter: int = 40, relative: bool = False,
                     precond_dtype=None, operator_dtype=None):
    """Batched PCG through K4 (pallas_pcg.py:284-382).

    Returns solve(S, gam (B, N, bs), guess (B, N, bs)) -> (x, iters).  The
    block-Jacobi inverse (for J, diag(1/d)) and r0 = gam - S guess are
    computed outside the kernel in the operands' dtype; the kernel solves
    from a zero iterate and x = guess + dx.  ``operator_dtype`` stores the
    packed diagonal blocks, ``precond_dtype`` their packed inverses, in a
    narrower dtype (bfloat16, float16, or float32 under float64 operands;
    the upper blocks keep the operands'); with a preconditioner stored
    narrower than the operands the loop exits on the true residual r'r
    (:335-336).  A storage dtype wider than the operands' raises TypeError
    (JAX would promote the whole solve).  CUDA tensors go to K4 (or
    raise), CPU tensors to ``pcg_fused_plain``."""
    _precond_code(precond)
    for name, dt in (("precond_dtype", precond_dtype),
                     ("operator_dtype", operator_dtype)):
        if dt is not None and dt not in STORAGE and dt != torch.float64:
            raise TypeError(f"{name} must be float64, float32, bfloat16 or "
                            f"float16, got {dt}")

    def solve(S: BlockTridiag, gam, guess):
        if S.nblocks != N or S.bs != bs:
            raise ValueError(f"solver built for N={N}, bs={bs}; got "
                             f"N={S.nblocks}, bs={S.bs}")
        r0 = gam - btd_matvec(S, guess)
        diag_p, upper, pdiag_p, r0p = pack_operands(S, r0, precond)
        if operator_dtype is not None:
            diag_p = diag_p.to(operator_dtype)
        if precond_dtype is not None:
            pdiag_p = pdiag_p.to(precond_dtype)
        fused = pcg_fused_kernel if on_card(r0) else pcg_fused_plain
        dx, iters = fused(diag_p, upper, pdiag_p, r0p, precond=precond,
                          tol=tol, max_iter=max_iter, relative=relative)
        return guess + dx.reshape(r0.shape), iters.reshape(r0.shape[:-2])

    return solve
