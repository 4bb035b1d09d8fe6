"""KKT blocks and the Schur-complement solve (exact or PCG) for the SQP
subproblem.

Port of trajoptmpcreference_tpu/solvers/kkt.py: ``KKTBlocks``,
``SchurSolveStats``, ``KKTSystem.form_blocks`` (cost, soft-constraint
Gauss-Newton terms, dynamics, defects, masked hard rows) and the three
Schur assemblies ``solve_schur`` dispatches between:

* split (no hard rows, (x, u)-block-diagonal G): ``_schur_blocks_split``
  and ``_recover_dxu_split``, block size nx;
* condensed (ACTIVE_SET hard rows, separable G): the hard multipliers
  eliminated per knot, ``_schur_blocks_condensed`` and
  ``_recover_condensed``, block size nx;
* generic (FULL_SET rows, or soft limits that mix x and u):
  ``schur_blocks`` and ``recover_dxu`` over row groups [defect; hard],
  block size nx + m.

The Schur system is solved exactly (block-Thomas or cyclic reduction) or
by PCG: ``btridiag.pcg``, or with ``use_kernel_pcg`` the fused PCG of
ops/fused_pcg.py (kernel K4 on CUDA tensors).  Method "N" assembles and
solves the dense KKT system instead (``solve_dense``): one (T + M)^2
matrix per scenario, LU with partial pivoting, and the normal equations
for the scenarios whose factorization meets a zero pivot.  With a
DeviceMesh, ``solve_schur_sharded`` partitions the generic assembly and
its solve over the mesh's horizon dim (parallel/horizon.py).

Every block carries the scenario batch as its leading axis: H (B, N, n, n),
g (B, N, n), A (B, N-1, nx, nx), B (B, N-1, nx, nu), defect (B, N, nx),
hval (B, N, m), hjac (B, N, m, n), hact (B, N, m).  Variable layout matches
the reference: z = [x_0, u_0, ..., x_{N-1}]; the terminal knot is padded to
width n = nx + nu with decoupled unit-diagonal phantom controls.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import torch

from trajoptmpcreference_tpu_torch.models.plants import Plant
from trajoptmpcreference_tpu_torch.ops.btridiag import (
    BlockTridiag,
    _bmm,
    _bmv,
    _solve_batched,
    btd_block_thomas,
    btd_cyclic_reduction,
    btd_matvec,
    pcg,
    preconditioner,
)
from trajoptmpcreference_tpu_torch.ops.fused_pcg import make_batched_pcg
from trajoptmpcreference_tpu_torch.solvers import constraints as C
from trajoptmpcreference_tpu_torch.solvers.costs import Cost


class KKTBlocks(NamedTuple):
    """Per-knot blocks, leading axes (B, N) (terminal knot padded)."""

    H: torch.Tensor        # (B, N, n, n)
    g: torch.Tensor        # (B, N, n)
    A: torch.Tensor        # (B, N-1, nx, nx)
    B: torch.Tensor        # (B, N-1, nx, nu)
    defect: torch.Tensor   # (B, N, nx): [x_0 - xs, x_{k+1} - f(x_k, u_k)...]
    hval: torch.Tensor     # (B, N, m)
    hjac: torch.Tensor     # (B, N, m, n)
    hact: torch.Tensor     # (B, N, m) bool


class SchurSolveStats(NamedTuple):
    pcg_iters: torch.Tensor
    pcg_converged: torch.Tensor
    # the PCG dual trace (ref: GBD-PCG-Python/PCG.py:82-95): |nu| and the
    # true |gamma - S lam| histories, (B, max_iter+1); set only by the
    # btridiag.pcg path with trace_residual=True
    nu_trace: Optional[torch.Tensor] = None
    res_trace: Optional[torch.Tensor] = None


def _sym(M):
    return 0.5 * (M + M.transpose(-1, -2))


@dataclasses.dataclass(frozen=True)
class KKTSystem:
    """All solver pieces for one (plant, cost, constraints, N, dt)."""

    plant: Plant
    cost: Cost
    cset: C.ConstraintSet
    N: int
    dt: float
    # exact Schur solver: "thomas" (block LU, sequential over N), "cr"
    # (block cyclic reduction), "cr_refine" (cr + one refinement step)
    exact_schur: str = "thomas"
    # route the Schur PCG through ops/fused_pcg (kernel K4 on CUDA tensors,
    # its plain version on CPU tensors) instead of btridiag.pcg; the
    # counterpart of the JAX use_pallas_pcg
    use_kernel_pcg: bool = False

    @property
    def nx(self) -> int:
        return self.plant.nx

    @property
    def nu(self) -> int:
        return self.plant.nu

    @property
    def n(self) -> int:
        return self.nx + self.nu

    @property
    def m(self) -> int:
        return self.cset.hard_rows_stage

    @property
    def bs(self) -> int:
        return self.nx + self.m

    # ------------------------------------------------------------- blocks
    def form_blocks(self, X, U, xs, cost_params, cstate) -> KKTBlocks:
        """All per-knot KKT blocks (ref: TrajoptMPCReference.py:118-271)
        in one batched pass over the (B, N-1) stage knots.
        X (B, nx, N), U (B, nu, N-1), xs (B, nx); cost_params with xg
        shaped (B, 1, 2k)."""
        N, nx, n = self.N, self.nx, self.n
        plant, cost, cs = self.plant, self.cost, self.cset
        Xk = X.transpose(-1, -2)                   # (B, N, nx)
        Xs = Xk[..., :-1, :]
        Us = U.transpose(-1, -2)                   # (B, N-1, nu)
        ks = torch.arange(N - 1, device=X.device)
        g_s, H_s = cost.stage_derivatives(cost_params, Xs, Us, ks)
        if cs.has_soft():
            # soft gradient and its Gauss-Newton term (ref: :149-150)
            gc = C.stage_soft_jacobian(cs, cstate, Xs, Us, ks)
            g_s = g_s + gc
            H_s = H_s + gc[..., :, None] * gc[..., None, :]
        A_s, B_s = plant.step_gradient(Xs, Us, self.dt)
        xpred = plant.step(Xs, Us, self.dt)
        hv_s, hj_s, ha_s = C.stage_hard_rows(cs, Xs, Us, terminal=False)

        # terminal knot (ref: :176-198), padded to width n
        xN = Xk[..., -1:, :]
        kN = torch.arange(N - 1, N, device=X.device)
        g_N, H_N = cost.term_derivatives(cost_params, xN, kN)
        if cs.has_soft():
            gcN = C.term_soft_jacobian(cs, cstate, xN, kN)
            g_N = g_N + gcN
            H_N = H_N + gcN[..., :, None] * gcN[..., None, :]
        H_pad = X.new_zeros(H_N.shape[:-2] + (n, n))
        H_pad[..., :, :] = torch.eye(n, dtype=X.dtype, device=X.device)
        H_pad[..., :nx, :nx] = H_N
        g_pad = X.new_zeros(g_N.shape[:-1] + (n,))
        g_pad[..., :nx] = g_N
        H = torch.cat([H_s, H_pad], dim=-3)
        g = torch.cat([g_s, g_pad], dim=-2)

        # defects: row 0 is the initial-state constraint (ref: :137-138)
        defect = torch.cat([(X[..., :, 0] - xs)[..., None, :],
                            Xk[..., 1:, :] - xpred], dim=-2)

        # hard rows, terminal group padded to m rows / n cols (inactive)
        hvN, hjN, haN = C.stage_hard_rows(cs, xN, None, terminal=True)
        m, mt = self.m, hvN.shape[-1]
        hvN_p = X.new_zeros(hvN.shape[:-1] + (m,))
        hvN_p[..., :mt] = hvN
        hjN_p = X.new_zeros(hjN.shape[:-2] + (m, n))
        hjN_p[..., :mt, :nx] = hjN
        haN_p = torch.zeros(haN.shape[:-1] + (m,), dtype=torch.bool,
                            device=X.device)
        haN_p[..., :mt] = haN
        return KKTBlocks(H, g, A_s, B_s, defect,
                         torch.cat([hv_s, hvN_p], dim=-2),
                         torch.cat([hj_s, hjN_p], dim=-3),
                         torch.cat([ha_s, haN_p], dim=-2))

    # --------------------------------------------- row-group jacobians E, F
    def _EF(self, blocks: KKTBlocks):
        """Row group k = [defect rows (nx); hard rows (m)] has jacobian E_k
        over knot k-1's variables and F_k over knot k's; returns (E, F
        (B, N, bs, n), rhs (B, N, bs), D (B, N, bs): 0 on live rows, -1 on
        pinned multipliers)."""
        nx, n, bs = self.nx, self.n, self.bs
        H = blocks.H
        lead = H.shape[:-3]
        E = H.new_zeros(lead + (self.N, bs, n))
        E[..., 1:, :nx, :] = -torch.cat([blocks.A, blocks.B], dim=-1)
        F = H.new_zeros(lead + (self.N, bs, n))
        F[..., :nx, :nx] = torch.eye(nx, dtype=H.dtype, device=H.device)
        F[..., nx:, :] = blocks.hjac
        rhs = torch.cat([blocks.defect, blocks.hval], dim=-1)
        live = torch.cat([torch.ones_like(blocks.defect, dtype=torch.bool),
                          blocks.hact], dim=-1)
        D = torch.where(live, 0.0, -1.0).to(H.dtype)
        return E, F, rhs, D

    def _regularized_G(self, blocks: KKTBlocks, rho):
        """G = H + rho I on the real decision variables; the phantom
        terminal controls keep their exact unit diagonal."""
        n, nx = self.n, self.nx
        eye = torch.eye(n, dtype=blocks.H.dtype, device=blocks.H.device)
        G = blocks.H + rho[..., None, None, None] * eye
        G[..., -1, nx:, nx:] = eye[nx:, nx:]
        return G

    def _g_split(self) -> Optional[int]:
        """nx when G is statically (x, u)-block-diagonal (separable cost
        Hessian, no soft Gauss-Newton term mixing x and u rows), else
        None."""
        if getattr(self.cost, "xu_coupled", False):
            return None
        if self.cset.has_soft() and not self.cset.soft_xu_separable():
            return None
        return self.nx

    # ----------------------------------------------------------- dense KKT
    def dense_kkt(self, blocks: KKTBlocks, rho):
        """The full KKT matrix and right-hand side of each scenario
        (kkt.py:241-276; ref: solveKKTSystem, TrajoptMPCReference.py:
        313-359): [[G, C^T], [C, diag(D)]] and [g; rhs], with G
        block-diagonal over the N knots and C's row group k holding F_k on
        the diagonal and E_k one block to the left.  Returns (KKT (B, T+M,
        T+M), b (B, T+M)), T = N n, M = N bs."""
        N, n, bs = self.N, self.n, self.bs
        T, M = N * n, N * bs
        E, F, rhs, D = self._EF(blocks)
        G = self._regularized_G(blocks, rho)
        dev = G.device
        k = torch.arange(N, device=dev)[:, None, None]
        row_x = k * n + torch.arange(n, device=dev)[None, :, None]   # (N, n, 1)
        col_x = k * n + torch.arange(n, device=dev)[None, None, :]   # (N, 1, n)
        row_c = T + k * bs + torch.arange(bs, device=dev)[None, :, None]
        KKT = G.new_zeros(G.shape[:-3] + (T + M, T + M))
        KKT[..., row_x, col_x] = G
        KKT[..., row_c, col_x] = F
        KKT[..., col_x.transpose(-1, -2), row_c.transpose(-1, -2)] = \
            F.transpose(-1, -2)
        KKT[..., row_c[1:], col_x[:-1]] = E[..., 1:, :, :]
        KKT[..., col_x[:-1].transpose(-1, -2), row_c[1:].transpose(-1, -2)] = \
            E[..., 1:, :, :].transpose(-1, -2)
        dj = torch.arange(T, T + M, device=dev)
        KKT[..., dj, dj] = D.flatten(-2)
        b = torch.cat([blocks.g.flatten(-2), rhs.flatten(-2)], dim=-1)
        return KKT, b

    def solve_dense(self, blocks: KKTBlocks, rho):
        """Assemble and solve the dense KKT system of every scenario
        (kkt.py:241-280).  Returns (dxu (B, N, n) with the terminal
        phantom controls, lam (B, N, bs), bad (B,)): ``bad`` marks the
        scenarios whose LU met a zero pivot or gave a non-finite solution,
        which are solved by ``_lstsq`` instead (ref: :353-357)."""
        N, n, bs = self.N, self.n, self.bs
        KKT, b = self.dense_kkt(blocks, rho)
        sol, bad = solve_kkt(KKT, b)
        return sol[..., :N * n].unflatten(-1, (N, n)), \
            sol[..., N * n:].unflatten(-1, (N, bs)), bad

    # ------------------------------------------------- generic Schur path
    def schur_blocks(self, blocks: KKTBlocks, rho):
        """S = D - C G^-1 C^T as a BlockTridiag plus gamma over row groups
        [defect; hard] (ref: solveKKTSystem_Schur,
        TrajoptMPCReference.py:417-424).  Returns (S, gam, invG, E, F)."""
        E, F, rhs, D = self._EF(blocks)
        G = self._regularized_G(blocks, rho)
        invG = _inv_psd(G, split_at=self._g_split())
        ET, FT = E.transpose(-1, -2), F.transpose(-1, -2)
        # S_kk = D_k - E_k invG_{k-1} E_k^T - F_k invG_k F_k^T
        Sd = torch.diag_embed(D) - _bmm(_bmm(F, invG), FT)
        Sd[..., 1:, :, :] -= _bmm(_bmm(E[..., 1:, :, :], invG[..., :-1, :, :]),
                                  ET[..., 1:, :, :])
        Sd = _sym(Sd)
        # S_{k,k+1} = -F_k invG_k E_{k+1}^T
        So = -_bmm(_bmm(F[..., :-1, :, :], invG[..., :-1, :, :]),
                   ET[..., 1:, :, :])
        # gamma_k = rhs_k - E_k invG_{k-1} g_{k-1} - F_k invG_k g_k
        gam = rhs - _bmv(F, _bmv(invG, blocks.g))
        gam[..., 1:, :] -= _bmv(E[..., 1:, :, :],
                                _bmv(invG[..., :-1, :, :], blocks.g[..., :-1, :]))
        return BlockTridiag(Sd, So), gam, invG, E, F

    def recover_dxu(self, invG, E, F, blocks: KKTBlocks, lam):
        """dxu = G^-1 (g - C^T lam) blockwise (ref: :449-452)."""
        rhs = blocks.g - (F * lam[..., :, None]).sum(-2)
        rhs[..., :-1, :] -= (E[..., 1:, :, :] * lam[..., 1:, :, None]).sum(-2)
        return _bmv(invG, rhs)

    def _can_split_schur(self) -> bool:
        """No hard-constraint rows and an (x, u)-block-diagonal G: row group
        k is the nx defect rows only, F_k = [I 0], E_k = [-A_{k-1} -B_{k-1}]."""
        return self.m == 0 and self._g_split() is not None

    def _schur_blocks_split(self, blocks: KKTBlocks, rho):
        """Schur assembly specialized to _can_split_schur():

          S_kk    = -iGxx_k - A_{k-1} iGxx_{k-1} A^T - B_{k-1} iGuu_{k-1} B^T
          S_k,k+1 =  iGxx_k A_k^T
          gam_k   = rhs_k - iGxx_k gx_k
                    + A_{k-1} iGxx_{k-1} gx_{k-1} + B_{k-1} iGuu_{k-1} gu_{k-1}

        rho: (B,) per-scenario regularization."""
        nx = self.nx
        dt, dev = blocks.H.dtype, blocks.H.device
        eye_x = torch.eye(nx, dtype=dt, device=dev)
        eye_u = torch.eye(self.nu, dtype=dt, device=dev)
        r = rho[..., None, None, None]
        Hxx = blocks.H[..., :nx, :nx] + r * eye_x
        Huu = blocks.H[..., nx:, nx:] + r * eye_u
        Huu[..., -1, :, :] = eye_u                # phantom terminal controls
        iGxx = _sym(_solve_batched(Hxx, eye_x.expand(Hxx.shape), spd=True))
        iGuu = _sym(_solve_batched(Huu, eye_u.expand(Huu.shape), spd=True))

        A, B = blocks.A, blocks.B
        iGA = _bmm(iGxx[..., :-1, :, :], A.transpose(-1, -2))
        iGB = _bmm(iGuu[..., :-1, :, :], B.transpose(-1, -2))
        Sd = -iGxx
        Sd[..., 1:, :, :] += -_bmm(A, iGA) - _bmm(B, iGB)
        Sd = _sym(Sd)
        So = iGA

        gx, gu = blocks.g[..., :nx], blocks.g[..., nx:]
        gam = blocks.defect - _bmv(iGxx, gx)
        gam[..., 1:, :] += (_bmv(A, _bmv(iGxx[..., :-1, :, :], gx[..., :-1, :]))
                            + _bmv(B, _bmv(iGuu[..., :-1, :, :], gu[..., :-1, :])))
        return BlockTridiag(Sd, So), gam, iGxx, iGuu

    def _recover_dxu_split(self, iGxx, iGuu, blocks: KKTBlocks, lam):
        """dxu_x = iGxx (gx - lam_k + A_k^T lam_{k+1}),
        dxu_u = iGuu (gu + B_k^T lam_{k+1})."""
        nx = self.nx
        gx, gu = blocks.g[..., :nx], blocks.g[..., nx:]
        rx = gx - lam
        rx[..., :-1, :] += _bmv(blocks.A.transpose(-1, -2), lam[..., 1:, :])
        ru = gu.clone()
        ru[..., :-1, :] += _bmv(blocks.B.transpose(-1, -2), lam[..., 1:, :])
        return torch.cat([_bmv(iGxx, rx), _bmv(iGuu, ru)], dim=-1)

    # --------------------------------------------------- condensed hard rows
    def _can_condense_hard(self) -> bool:
        """Hard rows are knot-local, so each knot's hard multipliers couple
        only to the defect multipliers at knots k and k+1 and are
        eliminated per knot by one batched (m, m) solve, leaving the
        nx-block core.  Needs the separable G of the split path, and
        ACTIVE_SET rows only: FULL_SET keeps both signed rows of a box live,
        which makes W exactly singular; it stays on the generic path."""
        return (self.m > 0 and self._g_split() is not None
                and all(l.mode == "ACTIVE_SET"
                        for l in self.cset.hard_limits))

    def _schur_blocks_condensed(self, blocks: KKTBlocks, rho):
        """Schur assembly with the hard rows condensed out (kkt.py:400-452):

          P_k = iGxx_k Jx_k^T,  Q_k = A_k iGxx_k Jx_k^T + B_k iGuu_k Ju_k^T
          W_k = Jx iGxx Jx^T + Ju iGuu Ju^T + diag(1 on inactive rows)
          S'_dd[k]    += P_k W_k^-1 P_k^T + Q_{k-1} W_{k-1}^-1 Q_{k-1}^T
          S'_d,k(k+1) -= P_k W_k^-1 Q_k^T
          gam'_k      -= P_k W_k^-1 gh_k - Q_{k-1} W_{k-1}^-1 gh_{k-1}
          gh_k         = hval_k - J_k invG_k g_k

        Inactive rows are masked in J and hval (form_blocks) and get a unit
        diagonal in W, which pins their multipliers to zero outside the
        block elimination.  Returns (S, gam, aux)."""
        nx, m = self.nx, self.m
        S, gam, iGxx, iGuu = self._schur_blocks_split(blocks, rho)
        Sd, So = S.diag, S.upper
        Jx = blocks.hjac[..., :nx]           # (B, N, m, nx)
        Ju = blocks.hjac[..., nx:]           # (B, N, m, nu)
        P = _bmm(iGxx, Jx.transpose(-1, -2))     # (B, N, nx, m)
        Uu = _bmm(iGuu, Ju.transpose(-1, -2))    # (B, N, nu, m)
        W = _bmm(Jx, P) + _bmm(Ju, Uu)           # (B, N, m, m)
        W = W + torch.diag_embed((~blocks.hact).to(W.dtype))
        W = _sym(W)
        iW = _sym(_inv_psd(W))
        A, Bm = blocks.A, blocks.B
        Q = _bmm(A, P[..., :-1, :, :]) + _bmm(Bm, Uu[..., :-1, :, :])
        gx, gu = blocks.g[..., :nx], blocks.g[..., nx:]
        gh = blocks.hval - _bmv(Jx, _bmv(iGxx, gx)) - _bmv(Ju, _bmv(iGuu, gu))
        PiW = _bmm(P, iW)                        # (B, N, nx, m)
        QiW = _bmm(Q, iW[..., :-1, :, :])        # (B, N-1, nx, m)
        Sd = Sd + _bmm(PiW, P.transpose(-1, -2))
        Sd[..., 1:, :, :] += _bmm(QiW, Q.transpose(-1, -2))
        Sd = _sym(Sd)
        So = So - _bmm(PiW[..., :-1, :, :], Q.transpose(-1, -2))
        gam = gam - _bmv(PiW, gh)
        gam[..., 1:, :] += _bmv(QiW, gh[..., :-1, :])
        return BlockTridiag(Sd, So), gam, (iGxx, iGuu, P, Q, iW, gh)

    def _recover_condensed(self, blocks: KKTBlocks, aux, lam_d):
        """Back out the hard multipliers, then dxu (kkt.py:454-476):

          lam_h,k = W_k^-1 (-gh_k - P_k^T lam_d,k + Q_k^T lam_d,k+1)
          rx_k    = gx_k - lam_d,k + A_k^T lam_d,k+1 - Jx_k^T lam_h,k
          ru_k    = gu_k + B_k^T lam_d,k+1 - Ju_k^T lam_h,k

        Returns (dxu (B, N, n), lam (B, N, nx + m) in the generic [defect;
        hard] layout, so the MPC carry does not depend on the path)."""
        nx = self.nx
        iGxx, iGuu, P, Q, iW, gh = aux
        r = -gh - _bmv(P.transpose(-1, -2), lam_d)
        r[..., :-1, :] += _bmv(Q.transpose(-1, -2), lam_d[..., 1:, :])
        lam_h = _bmv(iW, r)                      # (B, N, m)
        Jx = blocks.hjac[..., :nx]
        Ju = blocks.hjac[..., nx:]
        gx, gu = blocks.g[..., :nx], blocks.g[..., nx:]
        rx = gx - lam_d - _bmv(Jx.transpose(-1, -2), lam_h)
        rx[..., :-1, :] += _bmv(blocks.A.transpose(-1, -2), lam_d[..., 1:, :])
        ru = gu - _bmv(Ju.transpose(-1, -2), lam_h)
        ru[..., :-1, :] += _bmv(blocks.B.transpose(-1, -2), lam_d[..., 1:, :])
        dxu = torch.cat([_bmv(iGxx, rx), _bmv(iGuu, ru)], dim=-1)
        return dxu, torch.cat([lam_d, lam_h], dim=-1)

    def solve_schur(self, blocks: KKTBlocks, rho, use_pcg: bool = False,
                    pcg_tol: float = 1e-6, pcg_max_iter: int = 100,
                    precond: str = "SS", guess: Optional[torch.Tensor] = None,
                    pcg_relative: bool = False, trace_residual: bool = False):
        """Schur-complement solve, exact or PCG (ref:
        TrajoptMPCReference.py:361-455; kkt.py:478-541), on the split,
        condensed or generic assembly.  guess (B, N, nx + m) warm-starts
        PCG (sliced to its defect rows on the condensed core);
        trace_residual carries the PCG dual trace in the stats
        (btridiag.pcg path only).  Returns (dxu (B, N, n), lam (B, N,
        nx + m), stats)."""
        split = self._can_split_schur()
        condensed = not split and self._can_condense_hard()
        if split:
            S, gam, iGxx, iGuu = self._schur_blocks_split(blocks, rho)
        elif condensed:
            S, gam, caux = self._schur_blocks_condensed(blocks, rho)
            if guess is not None:
                guess = guess[..., :self.nx]
        else:
            S, gam, invG, E, F = self.schur_blocks(blocks, rho)
        if use_pcg:
            if self.use_kernel_pcg:
                solve = _fused_pcg_solver(self.N, S.bs, precond, pcg_tol,
                                          pcg_max_iter, pcg_relative)
                g0 = torch.zeros_like(gam) if guess is None else guess
                lam, iters = solve(S, gam, g0)
                stats = SchurSolveStats(iters, iters < pcg_max_iter)
            else:
                res = pcg(S, gam, preconditioner(S, precond), guess=guess,
                          exit_tolerance=pcg_tol, max_iter=pcg_max_iter,
                          relative=pcg_relative, trace_residual=trace_residual)
                lam = res.x
                stats = SchurSolveStats(res.iters, res.converged,
                                        nu_trace=res.nu_trace,
                                        res_trace=res.res_trace)
        else:
            if self.exact_schur in ("cr", "cr_refine"):
                lam = btd_cyclic_reduction(S, gam)
                if self.exact_schur == "cr_refine":
                    lam = lam + btd_cyclic_reduction(S, gam - btd_matvec(S, lam))
            else:
                lam = btd_block_thomas(S, gam)
            batch = rho.shape
            stats = SchurSolveStats(
                torch.zeros(batch, dtype=torch.long, device=rho.device),
                torch.ones(batch, dtype=torch.bool, device=rho.device))
        if split:
            dxu = self._recover_dxu_split(iGxx, iGuu, blocks, lam)
        elif condensed:
            dxu, lam = self._recover_condensed(blocks, caux, lam)
        else:
            dxu = self.recover_dxu(invG, E, F, blocks, lam)
        return dxu, lam, stats

    def solve_schur_sharded(self, blocks: KKTBlocks, rho, mesh, axis: str,
                            pcg_tol: float = 1e-6,
                            pcg_max_iter: int = 100,
                            precond: str = "SS",
                            guess: Optional[torch.Tensor] = None,
                            pcg_relative: bool = False,
                            exact: bool = False):
        """Horizon-sharded Schur solve (kkt.py:543-579): the per-knot
        inverse and assembly work and the solve, PCG or (``exact``) the
        SPIKE substructured direct solve, partitioned over ``axis`` of the
        DeviceMesh ``mesh`` (parallel.horizon.sharded_schur_solve), with
        the KKT blocks replicated on every rank.  It always takes the
        generic layout (row groups [defect; hard], bs = nx + m).  Returns
        (dxu (B, N, n), lam (B, N, bs), stats), replicated."""
        from trajoptmpcreference_tpu_torch.parallel.horizon import (
            sharded_schur_solve,
        )
        E, F, rhs, D = self._EF(blocks)
        G = self._regularized_G(blocks, rho)
        if guess is None:
            guess = torch.zeros_like(rhs)
        dxu, lam, iters, converged = sharded_schur_solve(
            E, F, rhs, D, G, blocks.g, guess, mesh.get_group(axis),
            precond=precond, exit_tolerance=pcg_tol, max_iter=pcg_max_iter,
            relative=pcg_relative, exact=exact)
        return dxu, lam, SchurSolveStats(iters, converged)


@functools.lru_cache(maxsize=None)
def _fused_pcg_solver(N: int, bs: int, precond: str, tol: float,
                      max_iter: int, relative: bool):
    """Cached per-(shape, hyperparameter) fused-PCG closure (kkt.py:580-587)."""
    return make_batched_pcg(N, bs, precond=precond, tol=tol,
                            max_iter=max_iter, relative=relative)


def solve_kkt(KKT, b):
    """x = KKT^-1 b per scenario by LU with partial pivoting; returns (x,
    bad).  A scenario is bad when the factorization reports a zero pivot
    or its solution has a non-finite entry (JAX tests the latter only,
    kkt.py:276; whether a zero pivot also yields inf differs between LAPACK
    builds).  The bad scenarios alone are solved again by ``_lstsq``, so a
    batch holds one LU's memory, never a second batch-wide system."""
    x, info = torch.linalg.solve_ex(KKT, b)
    bad = (info != 0) | ~torch.isfinite(x).all(-1)
    if bool(bad.any()):
        idx = bad.nonzero(as_tuple=True)
        x = x.index_put(idx, _lstsq(KKT[idx], b[idx]))
    return x, bad


def _lstsq(A, b):
    """Least squares by the normal equations with 1e-10 Tikhonov jitter
    (kkt.py:590-594), the JAX package's jit-safe stand-in for the
    reference's np.linalg.lstsq fallback (ref: :357).  A (..., m, m), b
    (..., m)."""
    At = A.transpose(-1, -2)
    AtA = At @ A + 1e-10 * torch.eye(A.shape[-1], dtype=A.dtype,
                                     device=A.device)
    return torch.linalg.solve(AtA, _bmv(At, b))


def _inv_psd(G, split_at: Optional[int] = None):
    """Batched inverse of small (regularized) SPD blocks (kkt.py:597-619).
    ``split_at=nx`` asserts the blocks are block-diagonal across the
    (state, control) partition and inverts the two diagonal blocks
    separately."""
    n = G.shape[-1]
    if split_at is None or split_at >= n:
        eye = torch.eye(n, dtype=G.dtype, device=G.device)
        return _solve_batched(G, eye.expand(G.shape), spd=True)
    nx = split_at
    Gxx, Guu = G[..., :nx, :nx], G[..., nx:, nx:]
    eye_x = torch.eye(nx, dtype=G.dtype, device=G.device)
    eye_u = torch.eye(n - nx, dtype=G.dtype, device=G.device)
    out = torch.zeros_like(G)
    out[..., :nx, :nx] = _solve_batched(Gxx, eye_x.expand(Gxx.shape), spd=True)
    out[..., nx:, nx:] = _solve_batched(Guu, eye_u.expand(Guu.shape), spd=True)
    return out
