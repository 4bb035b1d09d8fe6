"""KKT blocks and the split Schur solve (exact or PCG) for the SQP
subproblem.

Port of trajoptmpcreference_tpu/solvers/kkt.py for the slice:
``KKTBlocks``, ``SchurSolveStats``, ``KKTSystem.form_blocks``, and the
structure-exploiting Schur path for a cost Hessian that is (x, u)-block
diagonal with no hard-constraint rows (``_schur_blocks_split``,
``_recover_dxu_split``, ``solve_schur``).  The Schur system is solved
exactly (block-Thomas or cyclic reduction) or by PCG: ``btridiag.pcg``, or
with ``use_kernel_pcg`` the fused PCG of ops/fused_pcg.py (kernel K4 on
CUDA tensors).  The dense KKT (method "N"), the generic and condensed
Schur assemblies (hard rows) are still to be ported (ROADMAP queue 1).

Every block carries the scenario batch as its leading axis: H (B, N, n, n),
g (B, N, n), A (B, N-1, nx, nx), B (B, N-1, nx, nu), defect (B, N, nx).
Variable layout matches the reference: z = [x_0, u_0, ..., x_{N-1}]; the
terminal knot is padded to width n = nx + nu with decoupled unit-diagonal
phantom controls.
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
        A_s, B_s = plant.step_gradient(Xs, Us, self.dt)
        xpred = plant.step(Xs, Us, self.dt)
        hv_s, hj_s, ha_s = C.stage_hard_rows(cs, Xs, Us, terminal=False)

        # terminal knot (ref: :176-198), padded to width n
        xN = Xk[..., -1:, :]
        kN = torch.arange(N - 1, N, device=X.device)
        g_N, H_N = cost.term_derivatives(cost_params, xN, kN)
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

    def _g_split(self) -> Optional[int]:
        """nx when G is statically (x, u)-block-diagonal, else None."""
        if getattr(self.cost, "xu_coupled", False):
            return None
        if self.cset.has_soft() and not self.cset.soft_xu_separable():
            return None
        return self.nx

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

    def solve_schur(self, blocks: KKTBlocks, rho, use_pcg: bool = False,
                    pcg_tol: float = 1e-6, pcg_max_iter: int = 100,
                    precond: str = "SS", guess: Optional[torch.Tensor] = None,
                    pcg_relative: bool = False, trace_residual: bool = False):
        """Schur-complement solve, exact or PCG (ref:
        TrajoptMPCReference.py:361-455; kkt.py:478-541).  guess (B, N, bs)
        warm-starts PCG; trace_residual carries the PCG dual trace in the
        stats (btridiag.pcg path only).  Returns (dxu (B, N, n),
        lam (B, N, bs), stats)."""
        if not self._can_split_schur():
            raise NotImplementedError(
                "only the split Schur assembly (no hard rows, separable cost "
                "Hessian) is ported; see ROADMAP.md queue 1")
        S, gam, iGxx, iGuu = self._schur_blocks_split(blocks, rho)
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
        return self._recover_dxu_split(iGxx, iGuu, blocks, lam), lam, stats


@functools.lru_cache(maxsize=None)
def _fused_pcg_solver(N: int, bs: int, precond: str, tol: float,
                      max_iter: int, relative: bool):
    """Cached per-(shape, hyperparameter) fused-PCG closure (kkt.py:580-587)."""
    return make_batched_pcg(N, bs, precond=precond, tol=tol,
                            max_iter=max_iter, relative=relative)
