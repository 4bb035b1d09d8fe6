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
one-kernel PCG (K4) is ops/fused_pcg.py.  Both start the same way
(``warm_start``, ``residual_scale``): a warm start whose initial residual
is far worse than a zero start's is dropped, and under the relative exit
a large initial residual is scaled by a power of two so that the float32
dot products stay in range.  Small block inverses go through
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


# Under the relative exit a scenario's PCG runs on its initial residual r0
# times a power of two c: nu = r' Pinv r, pAp and the exit threshold all
# scale by c^2, so alpha, beta and the exit test are unchanged and every
# iterate is the unscaled one times c, bit for bit, wherever that stays
# finite and normal.  c = 1 while max|r0| <= 2**R0_LOG2_MAX, which holds
# for every ordinary input; past it, nu (N bs products of r and Pinv r)
# would near float32's 2**128 once the preconditioner's gain is added, so
# c brings max|r0| into [1/2, 1).  Only ever down: in the scaled units
# |nu_0| is then far above the relative exit's 1e-30 floor.  An absolute
# exit is not scale-invariant, so it runs unscaled.
R0_LOG2_MAX = 32


def pow2_scale(m: torch.Tensor) -> torch.Tensor:
    """The power of two c for a residual of max|r| = m: 1 where m <=
    2**R0_LOG2_MAX (or is not finite), else 2**-e with m = f 2**e, f in
    [1/2, 1).  Exact (f / m), with no host read."""
    f, _ = torch.frexp(m)
    big = (m > 2.0 ** R0_LOG2_MAX) & (m <= torch.finfo(m.dtype).max)
    return torch.where(big, f / m, 1.0)


def residual_scale(r: torch.Tensor) -> torch.Tensor:
    """``pow2_scale`` of each scenario's max|r| over r's (N, bs) axes."""
    return pow2_scale(r.abs().amax((-1, -2)))


# A warm start whose |nu_0| passes this many times a zero start's is
# dropped (``warm_start``).  In the PCG-SS flagship's float64 closed loop
# (B = 512, two episodes) the carried multipliers' ratio reached 2.8e10
# (~2**35) where they stayed under 1e6, and passed 2**40 only where they
# had grown (to 3.9e8); a float32 PCG on a Schur system that float32 makes
# indefinite can return multipliers whose ratio then grows ~1e3-1e6 times
# a step, past float32's range within ten to twenty steps.
WARM_START_NU_RATIO_MAX = 2.0 ** 40


def warm_start(b: torch.Tensor, guess: torch.Tensor, matvec, apply_P,
               dot=_dot, allmax=lambda m: m):
    """Where a warm-started PCG on A x = b starts, per scenario: from
    ``guess``, unless the guess gives an |nu_0| = |r0' Pinv r0| (r0 = b -
    A guess) more than ``WARM_START_NU_RATIO_MAX`` times a zero start's
    (|b' Pinv b|); then from zero.  ``matvec`` applies A to (..., N, bs),
    ``apply_P`` Pinv to the pair (2, ..., N, bs) of both starts' residuals,
    ``dot`` is the per-scenario inner product and ``allmax`` completes a
    per-scenario max (a horizon shard's: over the ranks).  The two are
    compared in units scaled by the smaller of their ``pow2_scale``, so
    that neither overflows.  Returns (x0, r0 = b - A x0, c =
    ``residual_scale(r0)``).

    A departure from the reference's upstream and from the JAX package,
    which start from any guess: it leaves the guesses of multipliers that
    stay in their usual range alone, and keeps a carried warm start that a
    float32 solve has blown up from growing on until it overflows."""
    r = b - matvec(guess)
    both = torch.stack([r, b])
    c = pow2_scale(allmax(both.abs().amax((-1, -2))))
    scaled = both * c.amin(0)[..., None, None]
    nu = dot(scaled, apply_P(scaled)).abs()
    zero = nu[0] > WARM_START_NU_RATIO_MAX * nu[1]
    keep = ~zero[..., None, None]
    return (torch.where(keep, guess, torch.zeros_like(guess)),
            torch.where(keep, r, b), torch.where(zero, c[1], c[0]))


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
    the true residual |b - A x| per iteration (one extra matvec).

    A guess is taken as ``warm_start`` says (dropped where it is far worse
    than none).  Under the relative exit the iteration runs on the system
    scaled by ``residual_scale`` of its initial residual (x, b and r times
    c, exactly; the traces and the result in the system's own units)."""
    if guess is None:
        x = torch.zeros_like(b)
        r = b - btd_matvec(A, x)
        cs = residual_scale(r)
    else:
        x, r, cs = warm_start(b, guess, lambda v: btd_matvec(A, v),
                              lambda v: btd_matvec(Pinv, v))
    if not relative:
        cs = torch.ones_like(cs)
    c = cs[..., None, None]
    x, r, b = x * c, r * c, b * c
    rt = btd_matvec(Pinv, r)
    p = rt
    nu = _dot(r, rt)
    lead = nu.shape
    trace = b.new_zeros(lead + (max_iter + 1,))
    trace[..., 0] = nu.abs() / cs / cs
    rtrace = None
    if trace_residual:
        rtrace = b.new_zeros(lead + (max_iter + 1,))
        rtrace[..., 0] = torch.linalg.vector_norm(r, dim=(-1, -2)) / cs
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
        trace[..., k + 1] = torch.where(done, trace[..., k + 1],
                                        nu_new.abs() / cs / cs)
        if trace_residual:
            true_r = torch.linalg.vector_norm(b - btd_matvec(A, x), dim=(-1, -2))
            rtrace[..., k + 1] = torch.where(done, rtrace[..., k + 1],
                                             true_r / cs)
        nu = torch.where(done, nu, nu_new)
        it = torch.where(done, it, it + 1)
        done = done | (nu_new.abs() <= thr)
    return PCGResult(x=x / c, iters=it, nu_trace=trace, converged=done,
                     res_trace=rtrace)
