"""Batched block-tridiagonal operators and the exact Schur solvers.

Port of trajoptmpcreference_tpu/ops/btridiag.py for the slice: the
symmetric block-tridiagonal matrix is kept as its blocks

  diag: (..., N, bs, bs)   upper: (..., N-1, bs, bs), lower = transpose

with any leading batch dimensions (scenarios), and solved exactly by
block cyclic reduction (log2(N) levels of batched block ops) or by
block-Thomas (a sequential loop over N).  Small block inverses go through
batched ``torch.linalg.solve_ex`` (LU with partial pivoting, no host sync),
the counterpart of the JAX package's CPU path; its TPU Gauss-Jordan branch
is not needed.  PCG, the preconditioners and kernel K4 are still to be
ported (ROADMAP queues 1 and 2).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


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


def btd_block_thomas(A: BlockTridiag, b: torch.Tensor) -> torch.Tensor:
    """Direct block-Thomas (block LU) solve, sequential over N
    (btridiag.py:383-430): C_k = Dt_k^-1 U_k, d_k = Dt_k^-1 (b_k - L_k d_{k-1})
    with Dt_k = D_k - L_k C_{k-1}; then x_k = d_k - C_k x_{k+1}."""
    N, bs = A.nblocks, A.bs
    lead = A.diag.shape[:-3]
    zero_blk = A.diag.new_zeros(lead + (bs, bs))
    C, d = [], []
    for k in range(N):
        Dk = A.diag[..., k, :, :]
        Uk = A.upper[..., k, :, :] if k < N - 1 else zero_blk
        bk = b[..., k, :, None]
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
    return torch.stack(xs, dim=-3)[..., 0]
