"""Horizon-sharded block-tridiagonal operators, PCG, the SPIKE exact solve
and the sharded Schur solve, over ``torch.distributed``.

Port of trajoptmpcreference_tpu/parallel/horizon.py.  The Schur complement
S is block-tridiagonal over the horizon (N block rows of size bs = nx +
m), so for long horizons its solve shards the block rows over the ranks
of a process group (a mesh's 'horizon' dim):

  * matvec: each rank owns L = N / P consecutive block rows; the coupling
    terms need one halo block row from each neighbour, exchanged with
    ``batch_isend_irecv`` (JAX: ``lax.ppermute``);
  * dot products and exit tests: a local partial and an all-reduce (JAX:
    ``psum``);
  * gathers of replicated outputs: an all-gather along the horizon axis
    (JAX: ``all_gather(tiled=True)``);
  * preconditioners: J / BJ are rank-local; SS takes one neighbour Dinv
    halo at setup, after which its application has the matvec's halo
    pattern.

Every function takes its LOCAL shard with the scenario batch leading, (B,
L, bs, bs) and (B, L, bs), and the process group of the horizon dim where
JAX takes the axis name inside ``shard_map``.  Each rank takes the same
trip counts: every exit and every host check reads all-reduced or
all-gathered values only, which are bit-equal on every rank.  On CUDA
tensors the group is the NCCL group it is given; nothing moves to the CPU.

Semantics match ops.btridiag.pcg (the same iterates in exact arithmetic;
ref: GBD-PCG-Python/PCG.py:66-212), with its per-scenario freeze.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from trajoptmpcreference_tpu_torch.ops.btridiag import (
    BlockTridiag,
    _bmm,
    _bmv,
    _bmv_T,
    _inv_blocks,
    btd_block_thomas,
    btd_block_thomas_multi,
)
from trajoptmpcreference_tpu_torch.parallel.multihost import (
    CALLS,
    all_gather_tiled,
    all_reduce_sum,
)


class ShardedBTD(NamedTuple):
    """A horizon shard (or the global layout) of a symmetric
    block-tridiagonal operator, scenario batch leading.

    Local view on rank p (L = N / P, global rows g0 = p L .. g0 + L - 1):
      diag: (B, L, bs, bs) diagonal blocks
      upper: (B, L, bs, bs), upper[:, k] = A[g0+k, g0+k+1]; the last
          global row's entry is zero padding
      upper_prev: (B, 1, bs, bs) = A[g0-1, g0] (zero on rank 0)

    Global layout (as ``shard_btd`` builds it): diag (B, N, bs, bs), upper
    (B, N, bs, bs), upper_prev (B, P, bs, bs); ``local(p, P)`` cuts rank
    p's view from it."""

    diag: torch.Tensor
    upper: torch.Tensor
    upper_prev: torch.Tensor

    def local(self, p: int, nshards: int) -> "ShardedBTD":
        L = self.diag.shape[-3] // nshards
        rows = slice(p * L, (p + 1) * L)
        return ShardedBTD(self.diag[..., rows, :, :],
                          self.upper[..., rows, :, :],
                          self.upper_prev[..., p:p + 1, :, :])


def shard_btd(A: BlockTridiag, nshards: int) -> ShardedBTD:
    """Lay out a global operator (..., N, bs, bs) for a horizon dim of
    ``nshards`` ranks: rank p takes rows p L:(p+1) L of every leaf (and
    row p of upper_prev)."""
    N, bs = A.nblocks, A.bs
    if N % nshards:
        raise ValueError(f"N={N} must divide by horizon shards {nshards}")
    L = N // nshards
    lead = A.diag.shape[:-3]
    zero = A.diag.new_zeros(lead + (1, bs, bs))
    upper = torch.cat([A.upper, zero], dim=-3)
    # A[g0-1, g0] for each shard = global upper index p L - 1
    idx = torch.arange(1, nshards, device=A.diag.device) * L - 1
    upper_prev = torch.cat([zero, A.upper[..., idx, :, :]], dim=-3)
    return ShardedBTD(A.diag, upper, upper_prev)


def _halo_exchange(x: torch.Tensor, group) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x_from_left, x_from_right) for the local shard x (B, L, ...): the
    left neighbour's LAST block row and the right neighbour's FIRST, (B,
    ...), zeros at the global boundary.  A one-rank group makes no call."""
    from_left = x.new_zeros(x[:, 0].shape)
    from_right = x.new_zeros(x[:, 0].shape)
    P = dist.get_world_size(group)
    if P == 1:
        return from_left, from_right
    p = dist.get_rank(group)
    peer = lambda r: dist.get_global_rank(group, r)
    ops = []
    if p > 0:
        ops += [dist.P2POp(dist.isend, x[:, 0].contiguous(), peer(p - 1), group),
                dist.P2POp(dist.irecv, from_left, peer(p - 1), group)]
    if p < P - 1:
        ops += [dist.P2POp(dist.isend, x[:, -1].contiguous(), peer(p + 1), group),
                dist.P2POp(dist.irecv, from_right, peer(p + 1), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    CALLS["p2p"] += 1
    return from_left, from_right


def sharded_btd_matvec(A: ShardedBTD, x: torch.Tensor, group) -> torch.Tensor:
    """y = S x for the local shard x (B, L, bs); one halo exchange of one
    block row each way per call."""
    x_left, x_right = _halo_exchange(x, group)
    y = _bmv(A.diag, x)
    # upper coupling: y_k += U_k x_{k+1}
    x_next = torch.cat([x[:, 1:], x_right[:, None]], dim=1)
    y = y + _bmv(A.upper, x_next)
    # lower coupling: y_k += U_{k-1}^T x_{k-1}
    x_prev = torch.cat([x_left[:, None], x[:, :-1]], dim=1)
    U_prev = torch.cat([A.upper_prev, A.upper[:, :-1]], dim=1)
    return y + _bmv_T(U_prev, x_prev)


def _pvdot(a, b, group):
    """Per-scenario inner product over the whole horizon, (B,)."""
    return all_reduce_sum((a * b).sum((-1, -2)), group)


def sharded_preconditioner(A: ShardedBTD, ptype: str, group) -> ShardedBTD:
    """Pinv in the same ShardedBTD layout (zero off blocks for 0 / J / BJ;
    ref: PCG.py:113-212)."""
    bs = A.diag.shape[-1]
    zero_u = torch.zeros_like(A.upper)
    zero_p = torch.zeros_like(A.upper_prev)
    if ptype == "0":
        eye = torch.eye(bs, dtype=A.diag.dtype, device=A.diag.device)
        return ShardedBTD(eye.expand(A.diag.shape).clone(), zero_u, zero_p)
    if ptype == "J":
        return ShardedBTD(torch.diag_embed(1.0 / A.diag.diagonal(0, -2, -1)),
                          zero_u, zero_p)
    if ptype == "BJ":
        return ShardedBTD(_inv_blocks(A.diag, spd=True), zero_u, zero_p)
    if ptype == "SS":
        Dinv = _inv_blocks(A.diag, spd=True)
        # Dinv of the right neighbour's first row and the left neighbour's
        # last row, for the boundary off-diagonal blocks
        Dinv_left, Dinv_right = _halo_exchange(Dinv, group)
        Dinv_next = torch.cat([Dinv[:, 1:], Dinv_right[:, None]], dim=1)
        U = -_bmm(_bmm(Dinv, A.upper), Dinv_next)
        U_prev = -(Dinv_left @ A.upper_prev[:, 0] @ Dinv[:, 0])[:, None]
        return ShardedBTD(Dinv, U, U_prev)
    raise ValueError(
        "Invalid preconditioner; options are [0, J, BJ, SS] "
        "(ref: PCG.py:52-55)")


class ShardedPCGResult(NamedTuple):
    x: torch.Tensor            # (B, L, bs) local shard
    iters: torch.Tensor        # (B,) long, replicated
    converged: torch.Tensor    # (B,) bool, replicated


def sharded_btd_exact(A: ShardedBTD, b: torch.Tensor, group) -> torch.Tensor:
    """Direct solve of the horizon-sharded block-tridiagonal system by
    substructuring (SPIKE / domain decomposition):

      1. each rank eliminates its L - 2 INTERIOR block rows with one local
         multi-RHS block-Thomas factorization, shared by the 2 bs + 1
         right-hand sides (b and the two interface coupling columns);
      2. the surviving unknowns, each rank's first and last block rows,
         form a reduced symmetric block-tridiagonal system of 2 P rows,
         all-gathered and solved redundantly on every rank by block-Thomas;
      3. the interior rows back-substitute locally.

    Three all-gathers, everything else rank-local; the same answer as the
    replicated btd_block_thomas up to float reassociation.  b (B, L, bs);
    needs L = N / P >= 3 local rows."""
    L, bs = A.diag.shape[-3], A.diag.shape[-1]
    if L < 3:
        raise ValueError(
            f"sharded_btd_exact needs >= 3 local block rows (got L = {L}); "
            "use fewer shards or the PCG path")
    p = dist.get_rank(group)
    # interior system: rows 1 .. L-2
    A_int = BlockTridiag(A.diag[:, 1:-1], A.upper[:, 1:L - 2])
    # RHS stack [b_I | C0 | Cl]: C0's first block = upper[0]^T (coupling to
    # x_0), Cl's last block = upper[L-2] (coupling to x_{L-1})
    nI = L - 2
    Bst = b.new_zeros((b.shape[0], nI, bs, 1 + 2 * bs))
    Bst[..., 0] = b[:, 1:-1]
    Bst[:, 0, :, 1:1 + bs] = A.upper[:, 0].transpose(-1, -2)
    Bst[:, -1, :, 1 + bs:] = A.upper[:, L - 2]
    sol = btd_block_thomas_multi(A_int, Bst)
    yb = sol[..., 0]                        # A_II^-1 b_I        (B, nI, bs)
    Y0 = sol[..., 1:1 + bs]                 # A_II^-1 C0         (B, nI, bs, bs)
    Yl = sol[..., 1 + bs:]                  # A_II^-1 Cl

    # reduced interface rows of this shard:
    #  row 0:   (Sd0 - U0 Y0[0]) x_0 + (-U0 Yl[0]) x_l
    #           + upper_prev^T x_l^(p-1)               = b_0 - U0 yb[0]
    #  row L-1: (-U_{L-2}^T Y0[-1]) x_0
    #           + (Sd_{L-1} - U_{L-2}^T Yl[-1]) x_l
    #           + U_{L-1} x_0^(p+1)                    = b_{L-1} - U^T yb[-1]
    U0, Ul = A.upper[:, 0], A.upper[:, L - 2]
    d0 = A.diag[:, 0] - U0 @ Y0[:, 0]
    dl = A.diag[:, -1] - Ul.transpose(-1, -2) @ Yl[:, -1]
    fill = -(U0 @ Yl[:, 0])                 # x_0 <-> x_l within the shard
    r0 = b[:, 0] - _bmv(U0, yb[:, 0])
    rl = b[:, -1] - _bmv_T(Ul, yb[:, -1])

    # reduced global system over (x_0^(0), x_l^(0), x_0^(1), ...): diag
    # (2P), upper (2P-1) with upper[2p] = fill_p, upper[2p+1] = U_{L-1}^(p)
    red_diag = all_gather_tiled(torch.stack([d0, dl], 1), group, dim=1)
    red_upper = all_gather_tiled(torch.stack([fill, A.upper[:, L - 1]], 1),
                                 group, dim=1)
    red_rhs = all_gather_tiled(torch.stack([r0, rl], 1), group, dim=1)
    z = btd_block_thomas(BlockTridiag(red_diag, red_upper[:, :-1]), red_rhs)

    x0, xl = z[:, 2 * p], z[:, 2 * p + 1]
    x_int = (yb - _bmv(Y0, x0[:, None].expand(-1, nI, -1))
             - _bmv(Yl, xl[:, None].expand(-1, nI, -1)))
    return torch.cat([x0[:, None], x_int, xl[:, None]], dim=1)


def sharded_schur_solve(E, F, rhs, D, G, g, guess, group, *,
                        precond: str = "SS",
                        exit_tolerance: float = 1e-6,
                        max_iter: int = 100,
                        relative: bool = False,
                        exact: bool = False):
    """Horizon-sharded Schur-complement solve, the SQP integration point
    (ref: solveKKTSystem_Schur, TrajoptMPCReference.py:417-455),
    partitioned over the ranks of ``group``.

    Every input is REPLICATED, batch leading (the KKT blocks are O(N (n^2
    + bs n)), cheap to hold on every rank); the O(N n^3) inverse and
    assembly work and the solve are partitioned: each rank owns L = N / P
    consecutive knots, neighbour coupling moves over one-block halos, dot
    products are all-reduced.

    Layout (kkt.KKTSystem._EF): row group k has jacobian E_k over knot
    k-1's variables and F_k over knot k's; S_kk = D_k - E_k invG_{k-1}
    E_k^T - F_k invG_k F_k^T, S_{k,k+1} = -F_k invG_k E_{k+1}^T, gamma_k =
    rhs_k - E_k invG_{k-1} g_{k-1} - F_k invG_k g_k.

    Returns replicated (dxu (B, N, n), lam (B, N, bs), iters (B,),
    converged (B,))."""
    P, p = dist.get_world_size(group), dist.get_rank(group)
    N = G.shape[-3]
    if N % P:
        raise ValueError(f"N={N} must divide by the horizon axis size {P}")
    L = N // P
    rows = slice(p * L, (p + 1) * L)
    Gl, gl, El, Fl, rhsl, Dl, guessl = (
        a[:, rows] for a in (G, g, E, F, rhs, D, guess))

    invGl = _inv_blocks(Gl, spd=True)
    # halos: the left neighbour's last (invG, g) row, the right
    # neighbour's first E row (zeros at the global boundaries)
    invG_left, _ = _halo_exchange(invGl, group)
    g_left, _ = _halo_exchange(gl, group)
    _, E_right = _halo_exchange(El, group)
    invG_prev = torch.cat([invG_left[:, None], invGl[:, :-1]], dim=1)
    g_prev = torch.cat([g_left[:, None], gl[:, :-1]], dim=1)
    E_next = torch.cat([El[:, 1:], E_right[:, None]], dim=1)

    ElT, FlT = El.transpose(-1, -2), Fl.transpose(-1, -2)
    E_nextT = E_next.transpose(-1, -2)
    # E_0 = 0 globally, so the k = 0 row's EiE / gamma terms vanish on rank 0
    EiE = _bmm(_bmm(El, invG_prev), ElT)
    FiF = _bmm(_bmm(Fl, invGl), FlT)
    Sd = torch.diag_embed(Dl) - FiF - EiE
    # explicit symmetrization, as kkt.schur_blocks: the f32 products leave
    # rounding asymmetry and every linear path must solve the SAME operator
    Sd = 0.5 * (Sd + Sd.transpose(-1, -2))
    So = -_bmm(_bmm(Fl, invGl), E_nextT)   # zero at the last global row
    So_left, _ = _halo_exchange(So, group)
    S_sh = ShardedBTD(Sd, So, So_left[:, None])
    gam = (rhsl - _bmv(Fl, _bmv(invGl, gl))
           - _bmv(El, _bmv(invG_prev, g_prev)))

    batch = G.shape[:1]
    if exact:
        # method "S": the substructured direct solve
        lam_l = sharded_btd_exact(S_sh, gam, group)
        iters = torch.zeros(batch, dtype=torch.long, device=G.device)
        converged = torch.ones(batch, dtype=torch.bool, device=G.device)
    else:
        res = sharded_pcg(S_sh, gam, group, precond=precond, guess=guessl,
                          exit_tolerance=exit_tolerance, max_iter=max_iter,
                          relative=relative)
        lam_l, iters, converged = res.x, res.iters, res.converged
    # dxu_k = invG_k (g_k - F_k^T lam_k - E_{k+1}^T lam_{k+1})
    _, lam_right = _halo_exchange(lam_l, group)
    lam_next = torch.cat([lam_l[:, 1:], lam_right[:, None]], dim=1)
    dxu_l = _bmv(invGl, gl - _bmv_T(Fl, lam_l) - _bmv_T(E_next, lam_next))
    dxu = all_gather_tiled(dxu_l, group, dim=1)
    lam = all_gather_tiled(lam_l, group, dim=1)
    return dxu, lam, iters, converged


def sharded_pcg(A: ShardedBTD, b: torch.Tensor, group,
                precond: str = "SS",
                guess: Optional[torch.Tensor] = None,
                exit_tolerance: float = 1e-6,
                max_iter: int = 100,
                relative: bool = False) -> ShardedPCGResult:
    """Horizon-sharded PCG: the iterates of ops.btridiag.pcg, with
    halo-exchange matvecs and all-reduced dot products (ref loop
    semantics: PCG.py:66-111).  ``relative`` is btridiag.pcg's
    scale-invariant exit (|nu| <= tol |nu_0|, floored at 1e-30).

    Every scenario has its own threshold and stops updating once it has
    converged (the JAX loop's per-sample freeze under vmap), so its result
    does not depend on its batchmates.  ``done`` comes from all-reduced
    values alone, so every rank leaves the loop at the same iteration."""
    Pinv = sharded_preconditioner(A, precond, group)
    x = torch.zeros_like(b) if guess is None else guess
    r = b - sharded_btd_matvec(A, x, group)
    rt = sharded_btd_matvec(Pinv, r, group)
    p = rt
    nu = _pvdot(r, rt, group)
    thr = (exit_tolerance * nu.abs() if relative
           else torch.full_like(nu, exit_tolerance))
    if relative:
        thr = thr.clamp(min=1e-30)
    done = nu.abs() <= thr      # NaN / warm-start guard (btridiag.pcg)
    it = torch.zeros(nu.shape, dtype=torch.long, device=b.device)
    for _ in range(max_iter):
        if bool(done.all()):
            break
        Ap = sharded_btd_matvec(A, p, group)
        pAp = _pvdot(p, Ap, group)
        alpha = nu / torch.where(pAp != 0, pAp, torch.ones_like(pAp))
        a = alpha[:, None, None]
        x_new, r_new = x + a * p, r - a * Ap
        rt = sharded_btd_matvec(Pinv, r_new, group)
        nu_new = _pvdot(r_new, rt, group)
        p_new = rt + (nu_new / nu)[:, None, None] * p
        # the freeze: a converged scenario keeps x, r, p and nu
        keep = done[:, None, None]
        x = torch.where(keep, x, x_new)
        r = torch.where(keep, r, r_new)
        p = torch.where(keep, p, p_new)
        nu = torch.where(done, nu, nu_new)
        it = torch.where(done, it, it + 1)
        done = done | (nu_new.abs() <= thr)
    return ShardedPCGResult(x=x, iters=it, converged=done)
