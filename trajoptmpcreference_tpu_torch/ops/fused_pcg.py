"""Batched block-tridiagonal PCG as one fused kernel (K4).

Counterpart of trajoptmpcreference_tpu/ops/pallas_pcg.py.  The whole
Krylov loop of a scenario runs inside one CUDA thread block
(kernels/csrc/pcg.cu): the Schur blocks, the preconditioner and the Krylov
vectors stay in shared memory for the whole solve, where the XLA-style
``btridiag.pcg`` launches a dozen small ops per iteration.

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
from typing import Optional

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


def smem_bytes(N: int, bs: int, dtype: torch.dtype) -> int:
    """Shared memory K4 needs for one scenario: packed diagonal and
    preconditioner, the upper blocks, six Krylov vectors and the
    reduction scratch (pcg.cu ``smem_elems``)."""
    tri = bs * (bs + 1) // 2
    item = torch.empty((), dtype=dtype).element_size()
    return item * (2 * N * tri + N * bs * bs + 6 * N * bs + 33)


def check_fits(N: int, bs: int, dtype: torch.dtype) -> None:
    """Raise ValueError when one scenario's system does not fit the shared
    memory of one thread block."""
    need = smem_bytes(N, bs, dtype)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"K4 keeps a scenario's whole system in shared memory: N={N}, "
            f"bs={bs} in {dtype} needs {need} bytes, over the "
            f"{SMEM_LIMIT}-byte limit of one thread block")


def _precond_code(precond: str) -> int:
    if precond not in PRECONDS:
        raise ValueError(f"Invalid fused-PCG preconditioner {precond!r}; "
                         f"options are {PRECONDS}")
    return int(precond == "SS")


def pcg_fused_plain(diag_p, upper, pdiag_p, r0, *, precond: str, tol: float,
                    max_iter: int, relative: bool):
    """Plain version of K4 (pallas_pcg.py:123-206): solves S dx = r0 from
    dx = 0 for every scenario.  Returns (dx (B, N, bs), iters (B,) int32).

    apply_P is s = Dinv r, plus for SS s - Dinv (U s_{k+1} + U^T s_{k-1});
    the threshold is max(tol |nu_0|, 1e-30) when relative, else tol; a
    scenario that is done takes no step and keeps nu and p.  One host check
    per iteration ends the loop once every scenario is done."""
    ss = _precond_code(precond) == 1
    bs = r0.shape[-1]
    D = _unpack_sym(diag_p, bs)
    P = _unpack_sym(pdiag_p, bs)
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
    thr = ((tol * nu.abs()).clamp(min=1e-30) if relative
           else torch.full_like(nu, tol))
    done = nu.abs() <= thr
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
        it = torch.where(done, it, it + 1)
        done = done | (nu_new.abs() <= thr)
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
        if t.dtype != r0.dtype:
            raise TypeError("K4 operands must share one dtype")
        if not t.is_contiguous():
            raise ValueError("K4 operands must be contiguous")
    check_fits(N, bs, r0.dtype)
    return B, N, bs


def pcg_fused_kernel(diag_p, upper, pdiag_p, r0, *, precond: str, tol: float,
                     max_iter: int, relative: bool):
    """K4 on the card: one thread block per scenario; same arguments and
    results as ``pcg_fused_plain``."""
    from trajoptmpcreference_tpu_torch.kernels import _build
    code = _precond_code(precond)
    B, N, bs = _check_operands(diag_p, upper, pdiag_p, r0)
    dx = torch.empty_like(r0)
    iters = torch.empty((B,), dtype=torch.int32, device=r0.device)
    if B:
        suffix = "f32" if r0.dtype == torch.float32 else "f64"
        fn = getattr(_build.library("pcg"), f"tmr_pcg_{suffix}")
        stream = torch.cuda.current_stream(r0.device).cuda_stream
        ptr = lambda t: ctypes.c_void_p(t.data_ptr())
        rc = fn(ptr(diag_p), ptr(upper), ptr(pdiag_p), ptr(r0), ptr(dx),
                ptr(iters), B, N, bs, code, int(relative), max_iter,
                float(tol), ctypes.c_void_p(stream))
        if rc != 0:
            raise RuntimeError(f"CUDA kernel pcg failed: cudaError {rc}")
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
    computed outside the kernel; the kernel solves from a zero iterate and
    x = guess + dx.  CUDA tensors go to K4 (or raise), CPU tensors to
    ``pcg_fused_plain``.  A storage dtype other than the operands' (the
    TPU's bf16 preconditioner) is not ported."""
    if precond_dtype is not None or operator_dtype is not None:
        raise NotImplementedError(
            "precond_dtype / operator_dtype (lower-precision block storage "
            "and its true-residual exit) are not ported; see ROADMAP.md")
    _precond_code(precond)

    def solve(S: BlockTridiag, gam, guess):
        if S.nblocks != N or S.bs != bs:
            raise ValueError(f"solver built for N={N}, bs={bs}; got "
                             f"N={S.nblocks}, bs={S.bs}")
        r0 = gam - btd_matvec(S, guess)
        ops = pack_operands(S, r0, precond)
        fused = pcg_fused_kernel if on_card(r0) else pcg_fused_plain
        dx, iters = fused(*ops, precond=precond, tol=tol, max_iter=max_iter,
                          relative=relative)
        return guess + dx.reshape(r0.shape), iters.reshape(r0.shape[:-2])

    return solve
