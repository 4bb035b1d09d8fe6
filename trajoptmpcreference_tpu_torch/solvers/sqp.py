"""SQP trajectory optimizer over a batch of scenarios.

Port of trajoptmpcreference_tpu/solvers/sqp.py (ref:
TrajoptMPCReference.py:510-760) for every method: "N" (the dense KKT
system, kkt.solve_dense), "S" (exact Schur solve) and "PCG-J" / "PCG-BJ" /
"PCG-SS" (the Schur system by PCG, warm-started from the previous
multipliers; ``use_kernel_pcg`` routes it through the fused kernel K4).
It holds the soft-constraint outer loop, the SQP iteration, and the
L1-merit line search (Nocedal & Wright 18.3), with the reference's exit
codes, rho schedule and merit weight, or with ``ls_fixed_alpha`` the real-
time iteration (a fixed step, clipped per scenario by ``rti_step_clip``;
``rti_lean`` skips every metric).  Box constraints enter through the soft
penalties in the cost, merit and directional derivative, the hard rows in
the violation and the KKT system, the AL outer loop's state updates,
``ls_step_clip`` (the constrained flagship's bound-jump guard) and
``hard_violation_exit_tol``.

Every tensor carries the scenario batch as its leading axis: X (B, nx, N),
U (B, nu, N-1), scalars (B,).  The JAX ``lax.while_loop``s with freeze gates
become Python loops over the iteration budget with per-scenario masks: a
finished scenario's state is left unchanged by ``torch.where`` (the JAX
batch-invariance freeze, sqp.py:605-615, :673-675; the soft-constraint
state included), and one host check per iteration ends the loop once every
scenario is done.

With a ``mesh`` (a DeviceMesh with a 'horizon' dim) the Schur solve runs
horizon-sharded over that dim (kkt.solve_schur_sharded: PCG with halo
matvecs, or for method "S" the SPIKE exact solve); every rank runs the
whole SQP loop on replicated data and takes the same trip counts.
``trace_linsys`` carries the PCG dual trace in each iteration's QP stats,
which ``utils.trace.solve_traced`` records.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, NamedTuple, Optional

import torch

from trajoptmpcreference_tpu_torch.models.plants import Plant
from trajoptmpcreference_tpu_torch.solvers import constraints as C
from trajoptmpcreference_tpu_torch.solvers.costs import Cost, total_cost_diff
from trajoptmpcreference_tpu_torch.solvers.kkt import KKTSystem, SchurSolveStats

SQP_METHODS = ("N", "S", "PCG-J", "PCG-BJ", "PCG-SS")

# exit codes (ref: TrajoptMPCReference.py:463-508)
EXIT_TOL = 1
EXIT_RHO_MAX = 2
EXIT_MAX_ITER = 3
EXIT_SOFT_CONVERGED = 1
EXIT_SOFT_MAX_ITER = 2
EXIT_SOFT_MU_LIMIT = 3


@dataclasses.dataclass(frozen=True)
class SQPOptions:
    """Hyperparameters with the reference defaults
    (ref: TrajoptMPCReference.py:91-115); every field of the JAX
    SQPOptions, so conversion (convert.options_from_dict) is total.  See
    trajoptmpcreference_tpu/solvers/sqp.py for each field's rationale."""

    exit_tolerance: float = 1e-6
    max_iter: int = 100
    alpha_factor: float = 0.5
    alpha_min: float = 0.005
    rho_factor: float = 4.0
    rho_min: float = 1e-3
    rho_max: float = 1e3
    rho_init: float = 1e-3
    expected_reduction_min: float = 0.05
    expected_reduction_max: float = 3.0
    merit_mu: float = 10.0                  # 0: adaptive J0 / c0
    exit_tolerance_linSys: float = 1e-6
    max_iter_linSys: int = 100
    hard_violation_exit_tol: float = float("inf")
    pcg_relative: bool = False
    parallel_line_search: bool = False      # one batched pass over the ladder
    ls_grad_at_base: bool = False           # Armijo D = g(X, U) . dxu
    ls_fixed_alpha: float = 0.0             # > 0: RTI, a fixed step
    rti_lean: bool = False                  # RTI without metrics
    rti_step_clip: float = float("inf")     # RTI: max|alpha dU| per scenario
    ls_step_clip: float = float("inf")      # max|dU| per scenario; inf = off
    exit_tolerance_soft: float = 1e-6
    max_iter_soft: int = 10
    trace_linsys: bool = False              # PCG dual trace in the QP stats


class SQPResult(NamedTuple):
    X: torch.Tensor            # (B, nx, N)
    U: torch.Tensor            # (B, nu, N-1)
    exit_sqp: torch.Tensor     # (B,) int
    exit_soft: torch.Tensor    # (B,) int
    outer_iters: torch.Tensor  # (B,) int
    sqp_iters: torch.Tensor    # (B,) int (last outer round)
    J: torch.Tensor            # (B,) final cost
    viol: torch.Tensor         # (B,) final violation (defects + hard rows)
    cstate: Any                # final soft-constraint state, (B, 2s, T) each
    lam: torch.Tensor          # (B, N, bs) last multipliers


class LineSearchResult(NamedTuple):
    alpha: torch.Tensor
    accepted: torch.Tensor
    ls_iter: torch.Tensor
    Xc: torch.Tensor
    Uc: torch.Tensor
    dJ: torch.Tensor
    J_new: torch.Tensor
    c_new: torch.Tensor
    merit_new: torch.Tensor
    D: torch.Tensor
    ratio: torch.Tensor


def _where(mask, new, old):
    """torch.where with a (B,) mask broadcast over trailing dims."""
    m = mask.reshape(mask.shape + (1,) * (new.dim() - mask.dim()))
    return torch.where(m, new, old)


def _clip_factor(du_max, clip):
    """min(1, clip / max|dU|) per scenario: the factor that scales a step
    onto the trust region while keeping it on its ray."""
    return torch.minimum(torch.ones_like(du_max),
                         clip / torch.maximum(du_max,
                                              torch.full_like(du_max, 1e-30)))


def knot_params(cost_params):
    """Shape per-scenario goals (B, d) as (B, 1, d) so they broadcast over
    the knot axis of (B, K, ·) stage batches."""
    if cost_params.xg.dim() >= 2:
        return cost_params._replace(xg=cost_params.xg[..., None, :])
    return cost_params


@dataclasses.dataclass(frozen=True)
class SQPSolver:
    plant: Plant
    cost: Cost
    cset: C.ConstraintSet
    N: int
    dt: float
    method: str
    options: SQPOptions
    kkt: KKTSystem
    # horizon sharding (sqp.py:168-173): with a DeviceMesh the Schur
    # assembly and solve run partitioned over mesh[horizon_axis]
    # (kkt.solve_schur_sharded), for long horizons; a batch of scenarios
    # is split with parallel.shard_solve instead
    mesh: Optional[Any] = None
    horizon_axis: str = "horizon"

    def _ks(self, like):
        return torch.arange(self.N - 1, device=like.device)

    def _kN(self, like):
        return torch.arange(self.N - 1, self.N, device=like.device)

    # ------------------------------------------------------------- metrics
    def total_cost(self, X, U, cost_params, cstate):
        """(B,) cost with its soft penalties (sqp.py:176-186; ref:
        TrajoptMPCReference.py:296-310); cost_params as ``solve`` takes
        them."""
        return self._total_cost(X, U, knot_params(cost_params), cstate)

    def total_cost_diff(self, X, U, Xc, Uc, cost_params, cstate):
        """(B,) J(Xc, Uc) - J(X, U) from per-stage differences, safe from
        cancellation in f32 (sqp.py:188-195, costs.total_cost_diff)."""
        return total_cost_diff(self.cost, self.cset, cstate, self.N, X, U,
                               Xc, Uc, knot_params(cost_params))

    def total_violation(self, X, U, xs):
        """(B,) initial-state and dynamics defects plus the active hard
        rows (sqp.py:197-210; ref: TrajoptMPCReference.py:273-294)."""
        cs = self.cset
        Xk, Uk = X.transpose(-1, -2), U.transpose(-1, -2)
        Xs, XN = Xk[..., :-1, :], Xk[..., -1:, :]
        xpred = self.plant.step(Xs, Uk, self.dt)
        c_s = (Xk[..., 1:, :] - xpred).abs().sum(-1)
        c = (X[..., :, 0] - xs).abs().sum(-1)
        if cs.has_hard():
            c_s = c_s + C.stage_hard_values(cs, Xs, Uk, False).abs().sum(-1)
            c = c + C.stage_hard_values(cs, XN, None, True).abs().sum((-1, -2))
        return c_s.sum(-1) + c

    def _total_cost(self, X, U, cost_params, cstate):
        cs = self.cset
        Xk, Uk = X.transpose(-1, -2), U.transpose(-1, -2)
        Xs, XN = Xk[..., :-1, :], Xk[..., -1:, :]
        ks, kN = self._ks(X), self._kN(X)
        Js = self.cost.stage_value(cost_params, Xs, Uk, ks)
        JN = self.cost.term_value(cost_params, XN, kN)
        if cs.has_soft():
            Js = Js + C.stage_soft_value(cs, cstate, Xs, Uk, ks)
            JN = JN + C.term_soft_value(cs, cstate, XN, kN)
        return Js.sum(-1) + JN[..., 0]

    def base_metrics(self, X, U, xs, cost_params, cstate):
        """(total_cost, total_violation) (B,) (sqp.py:220-244); cost_params
        shaped by knot_params."""
        return (self._total_cost(X, U, cost_params, cstate),
                self.total_violation(X, U, xs))

    def _diff_metrics(self, X, U, Xc, Uc, xs, cost_params, cstate):
        """(J(Xc,Uc) - J(X,U), violation(Xc,Uc)) from per-stage
        differences (costs.total_cost_diff: never two totals, the soft
        penalties too, a difference of stage values for a cost without
        stage_value_diff; sqp.py:246-285).  Xc / Uc may carry extra leading
        dims (the ladder's rungs) that broadcast against X / U."""
        cs = self.cset
        dJ = total_cost_diff(self.cost, cs, cstate, self.N, X, U, Xc, Uc,
                             cost_params)
        Xck, Uck = Xc.transpose(-1, -2), Uc.transpose(-1, -2)
        Xcs, XcN = Xck[..., :-1, :], Xck[..., -1:, :]
        xpred = self.plant.step(Xcs, Uck, self.dt)
        c_s = (Xck[..., 1:, :] - xpred).abs().sum(-1)
        c = (Xc[..., :, 0] - xs).abs().sum(-1)
        if cs.has_hard():
            c_s = c_s + C.stage_hard_values(cs, Xcs, Uck, False).abs().sum(-1)
            c = c + C.stage_hard_values(cs, XcN, None, True).abs().sum((-1, -2))
        return dJ, c_s.sum(-1) + c

    def directional_derivative(self, Xc, Uc, dxu, cost_params, cstate):
        """D = sum_k grad_k . dxu_k (+ soft jacobians) at the candidate
        trajectory (ref: TrajoptMPCReference.py:636-648)."""
        cs = self.cset
        Xck, Uck = Xc.transpose(-1, -2), Uc.transpose(-1, -2)
        Xcs, XcN = Xck[..., :-1, :], Xck[..., -1:, :]
        ks, kN = self._ks(Xc), self._kN(Xc)
        g = self.cost.stage_gradient(cost_params, Xcs, Uck, ks)
        gN = self.cost.term_gradient(cost_params, XcN, kN)
        if cs.has_soft():
            g = g + C.stage_soft_jacobian(cs, cstate, Xcs, Uck, ks)
            gN = gN + C.term_soft_jacobian(cs, cstate, XcN, kN)
        D = (g * dxu[..., :-1, :]).sum((-1, -2))
        return D + (gN[..., 0, :] * dxu[..., -1, :self.plant.nx]).sum(-1)

    @functools.cached_property
    def _ladders(self):
        return {}

    def _ladder(self, like):
        """The alpha ladder as a tensor on like's device, built once per
        (dtype, device) (a host-to-device copy inside the loop would wait
        for the stream)."""
        key = (like.dtype, like.device)
        if key not in self._ladders:
            ladder = [1.0]
            while ladder[-1] > self.options.alpha_min:
                ladder.append(ladder[-1] * self.options.alpha_factor)
            self._ladders[key] = torch.tensor(ladder, dtype=like.dtype,
                                              device=like.device)
        return self._ladders[key]

    def merit_weight(self, J0, c0):
        """L1 merit weight: the parity constant, or (merit_mu = 0) the
        adaptive J0/c0 (ref: TrajoptMPCReference.py:545-546)."""
        o = self.options
        if o.merit_mu > 0:
            return torch.full_like(J0, o.merit_mu)
        return torch.where(c0 != 0, J0 / c0.clamp(min=1e-12),
                           torch.full_like(J0, 10.0))

    # ----------------------------------------------------------- line search
    def line_search(self, X, U, dxu, J, c, merit, xs, cost_params, cstate,
                    mu=None, D_base=None) -> LineSearchResult:
        """(ref: TrajoptMPCReference.py:606-744).  ``mu`` defaults to the
        options' merit weight (10 when it is adaptive, sqp.py:358-359).
        ``D_base``: with options.ls_grad_at_base, the alpha-independent
        directional derivative g(X, U) . dxu computed once by
        sqp_iterate."""
        o = self.options
        nx = self.plant.nx
        if mu is None:
            mu = torch.full_like(J, o.merit_mu if o.merit_mu > 0 else 10.0)
        dX = dxu[..., :nx].transpose(-1, -2)          # (B, nx, N)
        dU = dxu[..., :-1, nx:].transpose(-1, -2)     # (B, nu, N-1)

        def evaluate(alpha):
            # alpha broadcasts against (B,): (B,) or (K, 1) for the ladder
            a = alpha[..., None, None]
            Xc, Uc = X - a * dX, U - a * dU
            dJ, c_new = self._diff_metrics(X, U, Xc, Uc, xs, cost_params,
                                           cstate)
            D = (D_base if D_base is not None else self.directional_derivative(
                Xc, Uc, dxu, cost_params, cstate)).expand_as(dJ)
            delta_merit = -dJ + mu * (c - c_new)
            ratio = delta_merit / (alpha * (D - mu * c_new))
            ok = ((delta_merit >= 0)
                  & (ratio >= o.expected_reduction_min)
                  & (ratio <= o.expected_reduction_max))
            return dJ, J + dJ, c_new, merit - delta_merit, D, ratio, ok

        if o.ls_fixed_alpha > 0:
            return self._rti_step(X, U, dX, dU, J, c, merit, xs, cost_params,
                                  cstate, mu, D_base)
        if o.parallel_line_search:
            # the sequential loop tries alpha = 1, f, f^2, ... down to the
            # first value <= alpha_min (inclusive) — the exact same ladder,
            # built in Python floats (sqp.py:435-438)
            alphas = self._ladder(X)
            K = alphas.shape[0]
            dJ, J_new, c_new, merit_new, D, ratio, ok = evaluate(alphas[:, None])
            # first acceptable candidate, else the last tried (sqp.py:448)
            idx = torch.where(ok.any(0), ok.int().argmax(0),
                              torch.full_like(ok[0], K - 1, dtype=torch.long))
            pick = lambda t: t.gather(0, idx[None])[0]
            alpha = alphas[idx]
            a = alpha[:, None, None]
            return LineSearchResult(
                alpha=alpha, accepted=pick(ok), ls_iter=idx,
                Xc=X - a * dX, Uc=U - a * dU, dJ=pick(dJ), J_new=pick(J_new),
                c_new=pick(c_new), merit_new=pick(merit_new), D=pick(D),
                ratio=pick(ratio))

        # sequential ladder (sqp.py:465-498): per-scenario alpha; a finished
        # scenario keeps its state (the batched while_loop's select)
        zero = torch.zeros_like(J)
        false = torch.zeros(J.shape, dtype=torch.bool, device=J.device)
        s = dict(alpha=torch.ones_like(J), done=false, accepted=false,
                 ls_iter=torch.zeros(J.shape, dtype=torch.long, device=J.device),
                 dJ=zero, J_new=J, c_new=c, merit_new=merit, D=zero, ratio=zero)
        while not bool(s["done"].all()):
            dJ, J_new, c_new, merit_new, D, ratio, ok = evaluate(s["alpha"])
            done = ok | ~(s["alpha"] > o.alpha_min)
            new = dict(alpha=torch.where(done, s["alpha"],
                                         s["alpha"] * o.alpha_factor),
                       done=done, accepted=ok,
                       ls_iter=s["ls_iter"] + (~done).long(), dJ=dJ,
                       J_new=J_new, c_new=c_new, merit_new=merit_new, D=D,
                       ratio=ratio)
            s = {k: torch.where(s["done"], s[k], v) for k, v in new.items()}
        a = s["alpha"][:, None, None]
        return LineSearchResult(
            alpha=s["alpha"], accepted=s["accepted"], ls_iter=s["ls_iter"],
            Xc=X - a * dX, Uc=U - a * dU, dJ=s["dJ"], J_new=s["J_new"],
            c_new=s["c_new"], merit_new=s["merit_new"], D=s["D"],
            ratio=s["ratio"])

    def _rti_step(self, X, U, dX, dU, J, c, merit, xs, cost_params, cstate,
                  mu, D_base):
        """The real-time iteration (sqp.py:402-431): one unconditional step
        of ls_fixed_alpha, per scenario scaled so max|alpha dU| <=
        rti_step_clip (one factor for dX and dU); lean RTI carries J, c and
        the merit unchanged, otherwise one _diff_metrics pass updates them
        (D is D_base, or 0)."""
        o = self.options
        alpha = torch.full_like(J, o.ls_fixed_alpha)
        if math.isfinite(o.rti_step_clip):
            alpha = alpha * _clip_factor(alpha * dU.abs().amax((-1, -2)),
                                         o.rti_step_clip)
        a = alpha[..., None, None]
        Xc, Uc = X - a * dX, U - a * dU
        zero, one = torch.zeros_like(J), torch.ones_like(J)
        true = torch.ones(J.shape, dtype=torch.bool, device=J.device)
        ls_iter = torch.zeros(J.shape, dtype=torch.long, device=J.device)
        if o.rti_lean:
            return LineSearchResult(
                alpha=alpha, accepted=true, ls_iter=ls_iter, Xc=Xc, Uc=Uc,
                dJ=zero, J_new=J, c_new=c, merit_new=merit, D=zero, ratio=one)
        dJ, c_new = self._diff_metrics(X, U, Xc, Uc, xs, cost_params, cstate)
        delta_merit = -dJ + mu * (c - c_new)
        return LineSearchResult(
            alpha=alpha, accepted=true, ls_iter=ls_iter, Xc=Xc, Uc=Uc, dJ=dJ,
            J_new=J + dJ, c_new=c_new, merit_new=merit - delta_merit,
            D=zero if D_base is None else D_base, ratio=one)

    # ------------------------------------------------------------ QP solve
    def solve_qp(self, X, U, xs, cost_params, cstate, rho, guess):
        """The QP step at (X, U) (sqp.py:307-309); cost_params as ``solve``
        takes them, rho (B,)."""
        blocks = self.kkt.form_blocks(X, U, xs, knot_params(cost_params),
                                      cstate)
        return self.solve_qp_from_blocks(blocks, rho, guess)

    def solve_qp_from_blocks(self, blocks, rho, guess):
        """The QP step from the KKT blocks (sqp.py:311-338): method "N"
        solves the dense KKT system, the others exact Schur or PCG and its
        preconditioner; only PCG takes the multiplier warm start ``guess``.
        Returns (dxu, lam, stats, singular (B,)); singular is set by method
        "N" alone, for the scenarios its LU could not solve."""
        o = self.options
        if self.method == "N":
            dxu, lam, singular = self.kkt.solve_dense(blocks, rho)
            return dxu, lam, SchurSolveStats(
                torch.zeros_like(singular, dtype=torch.long),
                torch.ones_like(singular)), singular
        use_pcg = self.method.startswith("PCG")
        no_singular = lambda: torch.zeros(rho.shape, dtype=torch.bool,
                                          device=rho.device)
        if self.mesh is not None:
            # horizon-sharded Schur: PCG (halo matvecs) or, for method "S",
            # the SPIKE substructured exact solve (sqp.py:319-330)
            dxu, lam, stats = self.kkt.solve_schur_sharded(
                blocks, rho, self.mesh, self.horizon_axis,
                pcg_tol=o.exit_tolerance_linSys,
                pcg_max_iter=o.max_iter_linSys,
                precond=self.method[4:] if use_pcg else "SS", guess=guess,
                pcg_relative=o.pcg_relative, exact=not use_pcg)
            return dxu, lam, stats, no_singular()
        dxu, lam, stats = self.kkt.solve_schur(
            blocks, rho, use_pcg=use_pcg, pcg_tol=o.exit_tolerance_linSys,
            pcg_max_iter=o.max_iter_linSys,
            precond=self.method[4:] if use_pcg else "SS",
            guess=guess if use_pcg else None, pcg_relative=o.pcg_relative,
            trace_residual=o.trace_linsys)
        return dxu, lam, stats, no_singular()

    # --------------------------------------------------- one SQP iteration
    def sqp_iterate(self, X, U, J, c, merit, rho, drho, guess, mu, xs,
                    cost_params, cstate, hit_max):
        """One SQP iteration: QP solve, line search, rho schedule, exit
        logic (ref: TrajoptMPCReference.py:571-750)."""
        o = self.options
        blocks = self.kkt.form_blocks(X, U, xs, cost_params, cstate)
        dxu, lam, qp_stats, _ = self.solve_qp_from_blocks(blocks, rho, guess)
        if math.isfinite(o.ls_step_clip):
            # trust-region clip on the control part of the QP direction,
            # max|dU| per scenario; one factor keeps dxu on the ray
            du_max = dxu[..., :-1, self.plant.nx:].abs().amax((-1, -2))
            dxu = dxu * _clip_factor(du_max, o.ls_step_clip)[..., None, None]
        D_base = (blocks.g * dxu).sum((-1, -2)) if o.ls_grad_at_base else None
        ls = self.line_search(X, U, dxu, J, c, merit, xs, cost_params, cstate,
                              mu=mu, D_base=D_base)
        accepted = ls.accepted
        error = ~accepted
        X1 = _where(accepted, ls.Xc, X)
        U1 = _where(accepted, ls.Uc, U)
        J1 = torch.where(accepted, ls.J_new, J)
        c1 = torch.where(accepted, ls.c_new, c)
        merit1 = torch.where(accepted, ls.merit_new, merit)
        # regularization schedule (ref: :457-461, :466-468)
        drho_ok = (drho / o.rho_factor).clamp(max=1.0 / o.rho_factor)
        rho_ok = (rho * drho_ok).clamp(min=o.rho_min)
        drho_err = (drho * o.rho_factor).clamp(min=o.rho_factor)
        rho_err = (rho * drho_err).clamp(min=o.rho_min)
        rho1 = torch.where(accepted, rho_ok, rho_err)
        drho1 = torch.where(accepted, drho_ok, drho_err)
        # exit logic (ref: :463-481); delta_J from the cancellation-safe
        # line-search difference
        zero = torch.zeros_like(ls.ls_iter)
        exit_code = torch.where(error & (rho1 > o.rho_max),
                                zero + EXIT_RHO_MAX, zero)
        if o.ls_fixed_alpha > 0 and o.rti_lean:
            # lean RTI computes no metrics: the budget is the only exit
            tol_hit = torch.zeros_like(error)
        elif o.ls_fixed_alpha > 0:
            # RTI accepts every step, so a cost increase is progress toward
            # feasibility, not convergence: only a small |delta J| exits
            tol_hit = ls.dJ.abs() < o.exit_tolerance
        else:
            tol_hit = ~error & (-ls.dJ < o.exit_tolerance)
        if self.cset.has_hard() and math.isfinite(o.hard_violation_exit_tol):
            hv = C.max_hard_violation(self.cset, X1, U1)
            tol_hit = tol_hit & (hv <= o.hard_violation_exit_tol)
        exit_code = torch.where(tol_hit, zero + EXIT_TOL, exit_code)
        # max-iter only when no other exit fired this iteration
        exit_code = torch.where(hit_max & (exit_code == 0),
                                zero + EXIT_MAX_ITER, exit_code)
        return (X1, U1, J1, c1, merit1, rho1, drho1, exit_code, lam, ls,
                qp_stats)

    # ------------------------------------------------------------ SQP loop
    def sqp_round(self, X, U, xs, cost_params, cstate, guess0=None):
        """One inner SQP solve (ref: :571-750).
        Returns (X, U, exit_code, iters, J, c, lam)."""
        o = self.options
        if o.ls_fixed_alpha > 0 and o.rti_lean:
            # lean RTI never reads J, c or the merit (sqp.py:570-573)
            J0 = c0 = X.new_zeros(X.shape[:-2])
            mu = torch.full_like(J0, 10.0)
        else:
            J0, c0 = self.base_metrics(X, U, xs, cost_params, cstate)
            mu = self.merit_weight(J0, c0)
        if guess0 is None:
            guess0 = X.new_zeros(X.shape[:-2] + (self.N, self.kkt.bs))
        batch = J0.shape
        s = dict(X=X, U=U, J=J0, c=c0, merit=J0 + mu * c0,
                 rho=torch.full_like(J0, o.rho_init),
                 drho=torch.ones_like(J0),
                 it=torch.zeros(batch, dtype=torch.long, device=X.device),
                 exit_code=torch.zeros(batch, dtype=torch.long, device=X.device),
                 done=torch.zeros(batch, dtype=torch.bool, device=X.device),
                 guess=guess0)
        # every live scenario exits by max_iter (hit_max), so the budget
        # bounds the loop exactly as the JAX while_loop's trip count
        for _ in range(o.max_iter):
            hit_max = s["it"] == (o.max_iter - 1)
            (X1, U1, J1, c1, merit1, rho1, drho1, exit_code, lam, _ls,
             _stats) = self.sqp_iterate(
                s["X"], s["U"], s["J"], s["c"], s["merit"], s["rho"],
                s["drho"], s["guess"], mu, xs, cost_params, cstate, hit_max)
            done = exit_code > 0
            new = dict(X=X1, U=U1, J=J1, c=c1, merit=merit1, rho=rho1,
                       drho=drho1, it=torch.where(done, s["it"], s["it"] + 1),
                       exit_code=exit_code, done=done, guess=lam)
            # batch-invariance freeze (sqp.py:605-615)
            s = {k: _where(s["done"], s[k], v) for k, v in new.items()}
            if bool(s["done"].all()):
                break
        return s["X"], s["U"], s["exit_code"], s["it"], s["J"], s["c"], s["guess"]

    # ----------------------------------------------------------- full solve
    def solve(self, x0, u0, cost_params=None, cstate=None,
              guess=None) -> SQPResult:
        """Full SQP with the soft-constraint outer loop
        (ref: TrajoptMPCReference.py:510-760).  x0 (B, nx, N), u0
        (B, nu, N-1); cost_params.xg (d,) or per-scenario (B, d); ``guess``
        (B, N, bs) warm-starts the first QP's multipliers."""
        o = self.options
        cost_params = knot_params(self.cost.default_params
                                  if cost_params is None else cost_params)
        xs = x0[..., :, 0]
        batch = x0.shape[:-2]
        if cstate is None:
            cstate = self.cset.init_state(dtype=x0.dtype, device=x0.device,
                                          batch=batch)
        if guess is None:
            guess = x0.new_zeros(batch + (self.N, self.kkt.bs))
        izero = torch.zeros(batch, dtype=torch.long, device=x0.device)
        s = dict(X=x0, U=u0, cstate=cstate, outer_it=izero, exit_soft=izero,
                 exit_sqp=izero, sqp_iters=izero, J=x0.new_zeros(batch),
                 c=x0.new_zeros(batch),
                 done=torch.zeros(batch, dtype=torch.bool, device=x0.device),
                 lam=guess)
        for _ in range(o.max_iter_soft):
            X1, U1, exit_sqp, iters, J, c, lam = self.sqp_round(
                s["X"], s["U"], xs, cost_params, s["cstate"], guess0=s["lam"])
            # soft-constraint convergence checks (ref: :483-508)
            max_c = C.max_soft_violation(self.cset, s["cstate"], X1, U1)
            exit_soft = torch.where(max_c < o.exit_tolerance_soft,
                                    izero + EXIT_SOFT_CONVERGED, izero)
            hit_max = s["outer_it"] == (o.max_iter_soft - 1)
            exit_soft = torch.where(hit_max & (exit_soft == 0),
                                    izero + EXIT_SOFT_MAX_ITER, exit_soft)
            exiting = exit_soft > 0
            new_cstate, mu_at_limit = C.update_all_soft(self.cset, s["cstate"],
                                                        X1, U1)
            # only update the state when not exiting (ref: :501-507)
            cstate1 = C.select_state(exiting, s["cstate"], new_cstate)
            exit_soft = torch.where(~exiting & mu_at_limit,
                                    izero + EXIT_SOFT_MU_LIMIT, exit_soft)
            done = exit_soft > 0
            new = dict(X=X1, U=U1, exit_soft=exit_soft, exit_sqp=exit_sqp,
                       sqp_iters=iters, J=J, c=c, done=done, lam=lam,
                       outer_it=torch.where(hit_max | done, s["outer_it"],
                                            s["outer_it"] + 1))
            # batch-invariance freeze (sqp.py:673-675), the soft state too
            new["cstate"] = C.select_state(s["done"], s["cstate"], cstate1)
            s = {k: v if k == "cstate" else _where(s["done"], s[k], v)
                 for k, v in new.items()}
            if bool(s["done"].all()):
                break
        return SQPResult(X=s["X"], U=s["U"], exit_sqp=s["exit_sqp"],
                         exit_soft=s["exit_soft"], outer_iters=s["outer_it"],
                         sqp_iters=s["sqp_iters"], J=s["J"], viol=s["c"],
                         cstate=s["cstate"], lam=s["lam"])


def make_sqp(plant: Plant, cost: Cost, cset: Optional[C.ConstraintSet],
             N: int, dt: float, method: str = "N",
             options: Optional[SQPOptions] = None,
             exact_schur: str = "thomas",
             use_kernel_pcg: bool = False,
             mesh=None, horizon_axis: str = "horizon") -> SQPSolver:
    """Build an SQP solver (ref: TrajoptMPCReference.py:29-42,510;
    sqp.py:690-742).  ``method`` accepts a string or a SQPSolverMethods
    member: "N", "S", "PCG-J", "PCG-BJ" or "PCG-SS".
    exact_schur: "thomas", "cr" or "cr_refine" (method "S").
    use_kernel_pcg: run the PCG methods' Schur solve as the fused PCG of
    ops/fused_pcg (kernel K4 on CUDA tensors).
    mesh + horizon_axis: run the Schur phase horizon-sharded over the
    named dim of a DeviceMesh (parallel.make_mesh): the PCG methods
    iterate with halo matvecs, method "S" takes the SPIKE exact solve
    (parallel.horizon.sharded_btd_exact, >= 3 local block rows).  N must
    divide by the dim's size."""
    from trajoptmpcreference_tpu_torch.solvers.methods import method_str
    method = method_str(method)
    if method not in SQP_METHODS:
        raise ValueError(
            f"Invalid QP solver {method!r}; options are N (dense KKT), "
            "S (Schur), PCG-J / PCG-BJ / PCG-SS (ref: :590-596)")
    if exact_schur not in ("thomas", "cr", "cr_refine"):
        raise ValueError(
            f"Invalid exact_schur {exact_schur!r}; options are 'thomas', "
            "'cr' or 'cr_refine'")
    if cset is None:
        cset = C.ConstraintSet(plant.nq, plant.nv, plant.nu, N)
    options = options or SQPOptions()
    kkt = KKTSystem(plant=plant, cost=cost, cset=cset, N=N, dt=dt,
                    exact_schur=exact_schur, use_kernel_pcg=use_kernel_pcg)
    if mesh is not None:
        from trajoptmpcreference_tpu_torch.parallel.batch import axis_size
        if method == "N":
            raise ValueError(
                "horizon sharding requires a Schur method: PCG-* (halo "
                "matvec iterations) or S (SPIKE substructured exact solve)")
        P = axis_size(mesh, horizon_axis)
        if N % P:
            raise ValueError(
                f"N={N} must divide by the horizon axis size {P}")
        if method == "S" and N // P < 3:
            raise ValueError(
                f"the sharded exact solve needs >= 3 local block rows "
                f"(N={N}, shards={P}); use fewer shards or a PCG method")
    return SQPSolver(plant=plant, cost=cost, cset=cset, N=N, dt=dt,
                     method=method, options=options, kkt=kkt, mesh=mesh,
                     horizon_axis=horizon_axis)
