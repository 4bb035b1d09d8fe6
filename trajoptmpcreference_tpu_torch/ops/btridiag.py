"""Batched block-tridiagonal operators, preconditioners, PCG and the exact
Schur solvers.

Port of trajoptmpcreference_tpu/ops/btridiag.py: the symmetric
block-tridiagonal matrix is kept as its blocks

  diag: (..., N, bs, bs)   upper: (..., N-1, bs, bs), lower = transpose

with any leading batch dimensions (scenarios).  It is solved exactly by
block cyclic reduction (log2(N) levels of batched block ops) or by
block-Thomas (a sequential loop over N), or iteratively by ``pcg`` with the
reference's preconditioners ('0', 'J', 'BJ', 'SS'; ref: PCG.py:168-212).
``pcg`` is the counterpart of the JAX package's XLA PCG path; the fused
one-kernel PCG (K4) is ops/fused_pcg.py.  Small block inverses go through
batched ``torch.linalg.solve_ex`` (LU with partial pivoting, no host sync),
the counterpart of the JAX package's CPU path; its TPU Gauss-Jordan branch
is not needed.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from trajoptmpcreference_tpu_torch.utils import spans


def _bmv(A, x):
    """Batched block matvec [..., i, j] @ [..., j]."""
    return (A @ x[..., None])[..., 0]


def _bmv_T(A, x):
    """[..., j, i]^T @ [..., j] -> [..., i]."""
    return (A.transpose(-1, -2) @ x[..., None])[..., 0]


def _bmm(A, B):
    return A @ B


class BlockTridiag(NamedTuple):
    """Symmetric block-tridiagonal matrix: A[k, k+1] = upper[k],
    A[k+1, k] = upper[k]^T."""

    diag: torch.Tensor
    upper: torch.Tensor

    @property
    def nblocks(self) -> int:
        return self.diag.shape[-3]

    @property
    def bs(self) -> int:
        return self.diag.shape[-1]


def btd_matvec(A: BlockTridiag, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x with x as (..., N, bs)."""
    y = _bmv(A.diag, x)
    y[..., :-1, :] += _bmv(A.upper, x[..., 1:, :])
    y[..., 1:, :] += _bmv_T(A.upper, x[..., :-1, :])
    return y


def btd_dense(A: BlockTridiag) -> torch.Tensor:
    """Materialize as (..., N*bs, N*bs) (test oracle)."""
    N, bs = A.nblocks, A.bs
    lead = A.diag.shape[:-3]
    M = A.diag.new_zeros(lead + (N, bs, N, bs))
    k = torch.arange(N, device=A.diag.device)
    M[..., k, :, k, :] = A.diag.movedim(-3, 0)
    if N > 1:
        M[..., k[:-1], :, k[1:], :] = A.upper.movedim(-3, 0)
        M[..., k[1:], :, k[:-1], :] = A.upper.transpose(-1, -2).movedim(-3, 0)
    return M.reshape(lead + (N * bs, N * bs))


def btd_solve_dense(A: BlockTridiag, b: torch.Tensor) -> torch.Tensor:
    """Exact solve by materializing (small N; test oracle)."""
    x = torch.linalg.solve(btd_dense(A), b.flatten(-2)[..., None])[..., 0]
    return x.reshape(b.shape)


def _solve_batched(A, B, spd: bool = False):
    """Batched small linear solves A X = B.  ``spd`` documents that the
    blocks are symmetric (quasi-)definite; LU pivots regardless.  Singular
    blocks give non-finite values (no error, no host sync)."""
    return torch.linalg.solve_ex(A, B)[0]


def _inv_blocks(blocks, spd: bool = False):
    bs = blocks.shape[-1]
    eye = torch.eye(bs, dtype=blocks.dtype, device=blocks.device)
    return _solve_batched(blocks, eye.expand(blocks.shape), spd=spd)


def btd_cyclic_reduction(A: BlockTridiag, b: torch.Tensor) -> torch.Tensor:
    """Direct block cyclic-reduction solve (btridiag.py:298-380).

    Each level eliminates the odd-indexed blocks of the current (halved)
    system with one round of batched block ops, then back-substitutes level
    by level.  N need not be a power of two: the system is padded with
    decoupled identity blocks (zero rhs), which the reduction eliminates
    exactly."""
    N, bs = A.nblocks, A.bs
    lead = A.diag.shape[:-3]
    dt, dev = A.diag.dtype, A.diag.device
    Np = 1 << max(0, (N - 1).bit_length())
    D = A.diag
    # U_full[k] = A[k, k+1], zero-padded so U_full[n-1] = 0 at every level
    U = torch.cat([A.upper, A.diag.new_zeros(lead + (Np - N + 1, bs, bs))],
                  dim=-3)
    rhs = b
    if Np != N:
        eye = torch.eye(bs, dtype=dt, device=dev).expand(lead + (Np - N, bs, bs))
        D = torch.cat([D, eye], dim=-3)
        rhs = torch.cat([rhs, b.new_zeros(lead + (Np - N, bs))], dim=-2)

    zero1 = A.diag.new_zeros(lead + (1, bs, bs))
    zero1v = b.new_zeros(lead + (1, bs))
    stack = []
    n = Np
    while n > 1:
        D_even = D[..., 0::2, :, :]
        Dinv_odd = _inv_blocks(D[..., 1::2, :, :], spd=True)
        b_even, b_odd = rhs[..., 0::2, :], rhs[..., 1::2, :]
        UR = U[..., 0::2, :, :]                  # A[2m, 2m+1]
        Uodd = U[..., 1::2, :, :]                # A[2m+1, 2m+2]
        # left odd neighbour of even 2m is 2m-1 (coupling Uodd[m-1]); the
        # m = 0 row multiplies by an exact zero block
        ULp = torch.cat([zero1, Uodd[..., :-1, :, :]], dim=-3)
        Dinv_prev = torch.cat([zero1, Dinv_odd[..., :-1, :, :]], dim=-3)
        b_odd_prev = torch.cat([zero1v, b_odd[..., :-1, :]], dim=-2)
        ULt = ULp.transpose(-1, -2)
        URDinv = _bmm(UR, Dinv_odd)
        D_new = (D_even - _bmm(_bmm(ULt, Dinv_prev), ULp)
                 - _bmm(URDinv, UR.transpose(-1, -2)))
        U_new = -_bmm(URDinv, Uodd)
        U_new[..., -1, :, :] = 0.0
        b_new = (b_even - _bmv_T(ULp, _bmv(Dinv_prev, b_odd_prev))
                 - _bmv(UR, _bmv(Dinv_odd, b_odd)))
        stack.append((Dinv_odd, UR, Uodd, b_odd))
        D, U, rhs = D_new, U_new, b_new
        n //= 2

    x = _solve_batched(D[..., 0, :, :], rhs[..., 0, :, None], spd=True)[..., 0]
    x = x[..., None, :]                          # (..., 1, bs)
    # back substitution: x[2m+1] = inv(D[2m+1]) (b[2m+1] - U[2m]^T x[2m]
    #                                            - U[2m+1] x[2m+2])
    for Dinv_odd, UR, Uodd, b_odd in reversed(stack):
        x_next = torch.cat([x[..., 1:, :], zero1v], dim=-2)
        x_odd = _bmv(Dinv_odd, b_odd - _bmv_T(UR, x) - _bmv(Uodd, x_next))
        x = torch.stack([x, x_odd], dim=-2).reshape(lead + (-1, bs))
    return x[..., :N, :]


def btd_block_thomas_multi(A: BlockTridiag, B: torch.Tensor) -> torch.Tensor:
    """Block-Thomas with a stacked right-hand side B (..., N, bs, m): one
    block LU shared by the m columns (btridiag.py:383-423; the sharded
    exact solve's interior carries 2 bs + 1 of them).  C_k = Dt_k^-1 U_k,
    d_k = Dt_k^-1 (B_k - L_k d_{k-1}) with Dt_k = D_k - L_k C_{k-1}; then
    X_k = d_k - C_k X_{k+1}."""
    N, bs = A.nblocks, A.bs
    lead = A.diag.shape[:-3]
    zero_blk = A.diag.new_zeros(lead + (bs, bs))
    C, d = [], []
    for k in range(N):
        Dk = A.diag[..., k, :, :]
        Uk = A.upper[..., k, :, :] if k < N - 1 else zero_blk
        bk = B[..., k, :, :]
        if k == 0:
            Dt, dt = Dk, bk
        else:
            Lk = A.upper[..., k - 1, :, :].transpose(-1, -2)
            Dt = Dk - Lk @ C[-1]
            dt = bk - Lk @ d[-1]
        sol = _solve_batched(Dt, torch.cat([Uk, dt], dim=-1), spd=True)
        C.append(sol[..., :bs])
        d.append(sol[..., bs:])
    xs = [None] * N
    xs[N - 1] = d[N - 1]
    for k in range(N - 2, -1, -1):
        xs[k] = d[k] - C[k] @ xs[k + 1]
    return torch.stack(xs, dim=-3)


def btd_block_thomas(A: BlockTridiag, b: torch.Tensor) -> torch.Tensor:
    """Direct block-Thomas (block LU) solve of A x = b, b (..., N, bs),
    sequential over N (btridiag.py:426-433): ``btd_block_thomas_multi``
    with one column, the same operations on the same shapes."""
    return btd_block_thomas_multi(A, b[..., None])[..., 0]


# ------------------------------------------------------------ preconditioners

def preconditioner(A: BlockTridiag, ptype: str) -> BlockTridiag:
    """Pinv as a block-tridiagonal operator (zero off blocks for '0', 'J'
    and 'BJ'; btridiag.py:154-172)."""
    bs = A.bs
    zero_off = torch.zeros_like(A.upper)
    if ptype == "0":
        eye = torch.eye(bs, dtype=A.diag.dtype, device=A.diag.device)
        return BlockTridiag(eye.expand(A.diag.shape).clone(), zero_off)
    if ptype == "J":
        return BlockTridiag(torch.diag_embed(1.0 / A.diag.diagonal(0, -2, -1)),
                            zero_off)
    if ptype == "BJ":
        return BlockTridiag(_inv_blocks(A.diag, spd=True), zero_off)
    if ptype == "SS":
        return _symmetric_stair(A)
    raise ValueError(
        "Invalid preconditioner; options are [0: none, J: Jacobi, "
        "BJ: Block-Jacobi, SS: Symmetric Stair] (ref: PCG.py:52-55)")


def _symmetric_stair(A: BlockTridiag) -> BlockTridiag:
    """Symmetric-stair preconditioner (ref: PCG.py:181-212; btridiag.py:175).

    The stair inverse plus its symmetrization gives every off-diagonal
    block pair -inv(D_k) A[k, k+1] inv(D_{k+1}), with the block-Jacobi
    inverses on the diagonal."""
    Dinv = _inv_blocks(A.diag, spd=True)
    U = -_bmm(_bmm(Dinv[..., :-1, :, :], A.upper), Dinv[..., 1:, :, :])
    return BlockTridiag(Dinv, U)


# ---------------------------------------------------------------------- PCG

class PCGResult(NamedTuple):
    x: torch.Tensor            # (..., N, bs) solution
    iters: torch.Tensor        # (...,) long
    nu_trace: torch.Tensor     # (..., max_iter+1) |r^T Pinv r| history (0-padded)
    converged: torch.Tensor    # (...,) bool
    # (..., max_iter+1) true residual |b - A x| history when
    # trace_residual=True (ref: PCG.py:82-95 trace2), else None
    res_trace: Optional[torch.Tensor] = None


def _dot(a, b):
    """Per-scenario inner product over the (N, bs) trailing axes."""
    return (a * b).sum((-1, -2))


def pcg(A: BlockTridiag, b: torch.Tensor, Pinv: BlockTridiag,
        guess: Optional[torch.Tensor] = None,
        exit_tolerance: float = 1e-6, max_iter: int = 100,
        relative: bool = False, trace_residual: bool = False) -> PCGResult:
    """Batched preconditioned conjugate gradient (btridiag.py:219-288;
    ref: PCG.py:66-111): nu = r^T Pinv r, exit on |nu| <= tol (times |nu_0|
    when ``relative``, with a 1e-30 floor so a converged warm start never
    divides by pAp = 0), warm start from ``guess``.

    Every scenario of the leading axes has its own threshold and stops
    updating once it has converged (the JAX loop's per-lane freeze under
    vmap), so its result does not depend on its batchmates.  The loop runs
    to ``max_iter`` with masks and ends early on one host check per
    iteration once every scenario is done.  ``trace_residual`` also records
    the true residual |b - A x| per iteration (one extra matvec)."""
    x = torch.zeros_like(b) if guess is None else guess
    r = b - btd_matvec(A, x)
    rt = btd_matvec(Pinv, r)
    p = rt
    nu = _dot(r, rt)
    lead = nu.shape
    trace = b.new_zeros(lead + (max_iter + 1,))
    trace[..., 0] = nu.abs()
    rtrace = None
    if trace_residual:
        rtrace = b.new_zeros(lead + (max_iter + 1,))
        rtrace[..., 0] = torch.linalg.vector_norm(r, dim=(-1, -2))
    thr = (exit_tolerance * nu.abs() if relative
           else torch.full_like(nu, exit_tolerance))
    if relative:
        thr = thr.clamp(min=1e-30)
    done = nu.abs() <= thr
    it = torch.zeros(lead, dtype=torch.long, device=b.device)
    for k in range(max_iter):
        if spans.host_bool(done.all(), "btridiag.pcg"):
            break
        Ap = btd_matvec(A, p)
        pAp = _dot(p, Ap)
        alpha = nu / torch.where(pAp != 0, pAp, torch.ones_like(pAp))
        a = alpha[..., None, None]
        x_new, r_new = x + a * p, r - a * Ap
        rt = btd_matvec(Pinv, r_new)
        nu_new = _dot(r_new, rt)
        p_new = rt + (nu_new / nu)[..., None, None] * p
        # the freeze: a converged scenario keeps its state
        keep = done[..., None, None]
        x = torch.where(keep, x, x_new)
        r = torch.where(keep, r, r_new)
        p = torch.where(keep, p, p_new)
        trace[..., k + 1] = torch.where(done, trace[..., k + 1], nu_new.abs())
        if trace_residual:
            true_r = torch.linalg.vector_norm(b - btd_matvec(A, x), dim=(-1, -2))
            rtrace[..., k + 1] = torch.where(done, rtrace[..., k + 1], true_r)
        nu = torch.where(done, nu, nu_new)
        it = torch.where(done, it, it + 1)
        done = done | (nu_new.abs() <= thr)
    return PCGResult(x=x, iters=it, nu_trace=trace, converged=done,
                     res_trace=rtrace)
