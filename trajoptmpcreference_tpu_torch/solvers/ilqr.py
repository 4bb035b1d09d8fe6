"""iLQR / DDP trajectory optimizer over a batch of scenarios.

Port of trajoptmpcreference_tpu/solvers/ilqr.py: iLQR with soft
constraints only (ref: README.md:17), sharing the SQP driver's
regularization schedule, exit codes and soft-constraint outer loop (ref:
TrajoptMPCReference.py:457-508).

Every tensor carries the scenario batch as its leading axis: X (B, nx, N),
U (B, nu, N-1), K (B, N-1, nu, nx), scalars (B,).

* The linearization of all (scenario x knot) pairs is one batched call, so
  on the card kernel K1 runs once per iterate over B (N-1) lanes.
* ``backward`` is the Riccati recursion as a reverse loop over the knots on
  (B, ...) tensors; ``backward_parallel`` the same recursion as a
  hand-written log-depth reverse scan over the knot axis (Sarkka & Garcia-
  Fernandez's conditional value-function elements), ceil(log2 N) levels.
* ``rollout`` is sequential over the knots (each knot one dynamics step at
  B lanes, kernel K2 on the card), as the JAX forward ``lax.scan``.
* The JAX ``lax.while_loop``s under ``vmap`` run until every scenario is
  done and update only the scenarios still running.  Here they are Python
  loops with per-scenario masks: the line search's alpha stops at each
  scenario's own rung, the round and the soft loop freeze a finished
  scenario (``torch.where``), so a scenario's result never depends on its
  batchmates; one host check per trip ends a loop once every scenario is
  done.  A scenario that has finished (or whose line search cannot be
  accepted: a failed backward pass, a converged iterate) enters the line
  search already done — the JAX result discards what it would compute.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from trajoptmpcreference_tpu_torch.models.plants import Plant
from trajoptmpcreference_tpu_torch.solvers import constraints as C
from trajoptmpcreference_tpu_torch.solvers.costs import Cost, total_cost_diff
from trajoptmpcreference_tpu_torch.solvers.sqp import (
    EXIT_MAX_ITER,
    EXIT_RHO_MAX,
    EXIT_SOFT_CONVERGED,
    EXIT_SOFT_MAX_ITER,
    EXIT_SOFT_MU_LIMIT,
    EXIT_TOL,
    SQPOptions,
    _where,
    knot_params,
)


def _T(M):
    """Transpose the trailing matrix dims (batched-safe)."""
    return M.transpose(-1, -2)


def _matvec(M, v):
    """M v over the trailing dims: (..., a, b) x (..., b) -> (..., a)."""
    return (M @ v[..., None])[..., 0]


def _vecmat(v, M):
    """v' M over the trailing dims: (..., a) x (..., a, b) -> (..., b)."""
    return (v[..., None, :] @ M)[..., 0, :]


def _dot(a, b):
    return (a * b).sum(-1)


def _cho_guarded(Quu, rho):
    """Cholesky with a one-shot jitter fallback (ilqr.py:47-69): factor
    once; where the factor is bad, re-factor Quu + jit I with
    jit = max(10 rho, 1e-3 |tr Quu| / nu), the standard Levenberg fallback.
    Returns (L, ok): ``ok`` reports the FIRST factor, so the rho schedule
    still reacts.

    ``ok`` is the JAX definition: every factor entry finite and its
    diagonal positive, where JAX's ``cho_factor`` marks a failure by NaN.
    ``cholesky_ex`` marks it by ``info`` instead and leaves a partial
    factor, so ``info == 0`` is required as well, and a refactor that
    fails too is NaN, as in JAX.  Quu (..., nu, nu), rho broadcasts
    against its leading dims."""
    nu = Quu.shape[-1]
    I = torch.eye(nu, dtype=Quu.dtype, device=Quu.device)
    L, info = torch.linalg.cholesky_ex(Quu)
    diag = torch.diagonal(L, dim1=-2, dim2=-1)
    ok = ((info == 0) & torch.isfinite(L).flatten(-2).all(-1)
          & (diag > 0).all(-1))
    tr = torch.diagonal(Quu, dim1=-2, dim2=-1).sum(-1)
    jit = torch.maximum(10.0 * rho, 1e-3 * tr.abs() / nu)
    # where ok, the jitter is 0 and this factor equals the first one
    Lj, info_j = torch.linalg.cholesky_ex(
        Quu + torch.where(ok, torch.zeros_like(jit), jit)[..., None, None] * I)
    Lj = torch.where((info_j == 0)[..., None, None], Lj,
                     torch.full_like(Lj, float("nan")))
    return Lj, ok


class ILQRResult(NamedTuple):
    X: torch.Tensor            # (B, nx, N)
    U: torch.Tensor            # (B, nu, N-1)
    K: torch.Tensor            # (B, N-1, nu, nx) final feedback gains
    exit_ilqr: torch.Tensor    # (B,) int
    exit_soft: torch.Tensor    # (B,) int
    outer_iters: torch.Tensor  # (B,) int
    iters: torch.Tensor        # (B,) int (last outer round)
    J: torch.Tensor            # (B,)
    cstate: Any                # final soft-constraint state, (B, 2s, T) each


@dataclasses.dataclass(frozen=True)
class ILQRSolver:
    plant: Plant
    cost: Cost
    cset: C.ConstraintSet
    N: int
    dt: float
    options: SQPOptions
    # backward pass: False = sequential reverse loop (N-1 dependent steps);
    # True = the log-depth reverse scan (same iterates up to round-off)
    parallel_riccati: bool = False

    def _ks(self, like):
        return torch.arange(self.N - 1, device=like.device)

    def _kN(self, like):
        return torch.arange(self.N - 1, self.N, device=like.device)

    # ------------------------------------------------------------- helpers
    def total_cost(self, X, U, cost_params, cstate):
        """Stage + terminal cost, soft penalties included, (B,)
        (ref: TrajoptMPCReference.py:296-310).  cost_params.xg broadcasts
        over the knots (solvers.sqp.knot_params)."""
        cs = self.cset
        Xk, Uk = _T(X), _T(U)
        Xs, XN = Xk[..., :-1, :], Xk[..., -1:, :]
        ks, kN = self._ks(X), self._kN(X)
        Js = self.cost.stage_value(cost_params, Xs, Uk, ks)
        JN = self.cost.term_value(cost_params, XN, kN)
        if cs.has_soft():
            Js = Js + C.stage_soft_value(cs, cstate, Xs, Uk, ks)
            JN = JN + C.term_soft_value(cs, cstate, XN, kN)
        return Js.sum(-1) + JN[..., 0]

    def _expansions(self, X, U, cost_params, cstate):
        """Linearization and cost expansion at every knot of every
        scenario in one batched call: A (B, N-1, nx, nx), B (B, N-1, nx,
        nu), g (B, N-1, nx+nu), H (B, N-1, nx+nu, nx+nu), gN (B, nx), HN
        (B, nx, nx)."""
        cs = self.cset
        Xk, Uk = _T(X), _T(U)
        Xs, XN = Xk[..., :-1, :], Xk[..., -1:, :]
        ks, kN = self._ks(X), self._kN(X)
        A, B = self.plant.step_gradient(Xs, Uk, self.dt)
        g, H = self.cost.stage_derivatives(cost_params, Xs, Uk, ks)
        gN, HN = self.cost.term_derivatives(cost_params, XN, kN)
        if cs.has_soft():
            # the Gauss-Newton soft term, as the SQP path
            gc = C.stage_soft_jacobian(cs, cstate, Xs, Uk, ks)
            g = g + gc
            H = H + gc[..., :, None] * gc[..., None, :]
            gcN = C.term_soft_jacobian(cs, cstate, XN, kN)
            gN = gN + gcN
            HN = HN + gcN[..., :, None] * gcN[..., None, :]
        return A, B, g, H, gN[..., 0, :], HN[..., 0, :, :]

    # ------------------------------------------------------- backward pass
    def backward(self, A, B, g, H, gN, HN, rho):
        """Riccati recursion as a reverse loop over the knots
        (ilqr.py:136-177).  rho (B,) is added to Quu (Levenberg-style).
        Returns (K (B, N-1, nu, nx), kff (B, N-1, nu), dv1 (B,), dv2 (B,),
        bad (B,))."""
        nx, nu = self.plant.nx, self.plant.nu
        I = torch.eye(nu, dtype=A.dtype, device=A.device)
        rhoI = rho[..., None, None] * I
        Vx, Vxx = gN, HN
        dv1 = torch.zeros_like(rho)
        dv2 = torch.zeros_like(rho)
        bad = torch.zeros(rho.shape, dtype=torch.bool, device=rho.device)
        Ks, ks = [None] * (self.N - 1), [None] * (self.N - 1)
        for k in range(self.N - 2, -1, -1):
            Ak, Bk, gk, Hk = A[:, k], B[:, k], g[:, k], H[:, k]
            AT, BT = _T(Ak), _T(Bk)
            Qx = gk[..., :nx] + _matvec(AT, Vx)
            Qu = gk[..., nx:] + _matvec(BT, Vx)
            Qxx = Hk[..., :nx, :nx] + AT @ Vxx @ Ak
            Quu = Hk[..., nx:, nx:] + BT @ Vxx @ Bk + rhoI
            Qux = Hk[..., nx:, :nx] + BT @ Vxx @ Ak
            # gains via the guarded Cholesky: a non-PD Quu flags ``bad``
            # while a jittered refactor keeps the recursion finite
            L, ok = _cho_guarded(Quu, rho)
            Kk_kk = torch.cholesky_solve(
                torch.cat([Qux, Qu[..., None]], -1), L)
            Kk, kk = Kk_kk[..., :nx], Kk_kk[..., nx]
            Vx = Qx - _matvec(_T(Qux), kk)
            Vxx = Qxx - _T(Qux) @ Kk
            Vxx = 0.5 * (Vxx + _T(Vxx))
            dv1 = dv1 + _dot(Qu, kk)
            dv2 = dv2 + _dot(_vecmat(kk, Quu), kk)
            bad = bad | ~ok
            Ks[k], ks[k] = Kk, kk
        return torch.stack(Ks, 1), torch.stack(ks, 1), dv1, dv2, bad

    # ------------------------------------------- parallel backward pass
    @staticmethod
    def _combine(e1, e2):
        """Compose the value-function elements e1 (earlier in time) and e2
        (later), batched over leading dims (ilqr.py:236-258):
        M = (I + C1 J2)^-1, and (I + J2 C1)^-1 = M^T for symmetric C1, J2."""
        A1, b1, C1, n1, J1 = e1
        A2, b2, C2, n2, J2 = e2
        nx = A1.shape[-1]
        I = torch.eye(nx, dtype=A1.dtype, device=A1.device)
        LHS = I + C1 @ J2
        # one LU for M [A1 | b1 | C1 n2 | C1], one for M^T [...]
        W = torch.linalg.solve(LHS, torch.cat(
            [A1, b1[..., None], _matvec(C1, n2)[..., None], C1], -1))
        MA1, Mb, MCn, MC1 = (W[..., :nx], W[..., nx], W[..., nx + 1],
                             W[..., nx + 2:])
        A12 = A2 @ MA1
        b12 = _matvec(A2, Mb + MCn) + b2
        C12 = A2 @ MC1 @ _T(A2) + C2
        V = torch.linalg.solve(_T(LHS), torch.cat(
            [(n2 - _matvec(J2, b1))[..., None], J2 @ A1], -1))
        n12 = _matvec(_T(A1), V[..., 0]) + n1
        J12 = _T(A1) @ V[..., 1:] + J1
        return (A12, b12, 0.5 * (C12 + _T(C12)), n12, 0.5 * (J12 + _T(J12)))

    @classmethod
    def _suffix_scan(cls, elems):
        """Suffix products over the knot axis (axis 1) of the element
        tensors: element k becomes e_k . e_{k+1} . ... . e_{n-1}, the
        earlier element first in every combine.  Hillis-Steele: at level
        d = 1, 2, 4, ... every k with k + d < n becomes combine(e_k,
        e_{k+d}); ceil(log2 n) levels, each one batched combine."""
        n = elems[0].shape[1]
        d = 1
        while d < n:
            comb = cls._combine([e[:, :n - d] for e in elems],
                                [e[:, d:] for e in elems])
            elems = [torch.cat([c, e[:, n - d:]], 1)
                     for c, e in zip(comb, elems)]
            d *= 2
        return elems

    def backward_parallel(self, A, B, g, H, gN, HN, rho):
        """Riccati recursion as a log-depth reverse scan over the knot axis
        (ilqr.py:179-284): each knot is a conditional value-function
        element (Ae, be, Ce, eta, J) (Sarkka & Garcia-Fernandez, IEEE TAC
        2023), the terminal cost a C = 0 element, and element k of the
        suffix scan carries the sequential pass's value expansion,
        Vxx_k = J_k, Vx_k = -eta_k; the gains then come pointwise from the
        values at k+1, so the result matches ``backward`` to round-off.

        The scan (``_suffix_scan``) combines the earlier element first —
        the order the JAX pass gets by swapping the arguments of
        ``associative_scan(..., reverse=True)`` (ilqr.py:260-264); each of
        its ceil(log2 N) levels is one batched combine over every
        (scenario, knot) pair.

        PD precondition (stronger than the sequential pass, as in JAX):
        the element build factors Huu + rho I per stage."""
        nx, nu = self.plant.nx, self.plant.nu
        dtype, dev = A.dtype, A.device
        Inu = torch.eye(nu, dtype=dtype, device=dev)
        rhoI = rho[..., None, None, None] * Inu
        gx, gu = g[..., :nx], g[..., nx:]
        Hxx, Huu, Hux = H[..., :nx, :nx], H[..., nx:, nx:], H[..., nx:, :nx]
        L, ok_e = _cho_guarded(Huu + rhoI, rho[..., None])
        W = torch.cholesky_solve(
            torch.cat([Hux, gu[..., None], _T(B)], -1), L)
        WHux, Wgu, WBt = W[..., :nx], W[..., nx], W[..., nx + 1:]
        Ae = A - B @ WHux
        be = -_matvec(B, Wgu)
        Ce = B @ WBt
        Je = Hxx - _T(Hux) @ WHux
        eta = -gx + _matvec(_T(Hux), Wgu)
        zm = A.new_zeros(A.shape[:1] + (1, nx, nx))
        zv = A.new_zeros(A.shape[:1] + (1, nx))
        elems = [torch.cat([Ae, zm], 1), torch.cat([be, zv], 1),
                 torch.cat([0.5 * (Ce + _T(Ce)), zm], 1),
                 torch.cat([eta, -gN[:, None]], 1),
                 torch.cat([0.5 * (Je + _T(Je)), HN[:, None]], 1)]
        elems = self._suffix_scan(elems)
        Vx1, Vxx1 = -elems[3][:, 1:], elems[4][:, 1:]
        BT = _T(B)
        Qu = gu + _matvec(BT, Vx1)
        Quu = Huu + BT @ Vxx1 @ B + rhoI
        Qux = Hux + BT @ Vxx1 @ A
        L, ok_g = _cho_guarded(Quu, rho[..., None])
        Kk_kk = torch.cholesky_solve(torch.cat([Qux, Qu[..., None]], -1), L)
        K, kff = Kk_kk[..., :nx], Kk_kk[..., nx]
        dv1 = _dot(Qu, kff).sum(-1)
        dv2 = _dot(_vecmat(kff, Quu), kff).sum(-1)
        bad = ~(ok_e.all(-1) & ok_g.all(-1))
        return K, kff, dv1, dv2, bad

    # -------------------------------------------------------- forward pass
    def rollout(self, X, U, K, kff, alpha):
        """Feedback rollout x' = f(x', u - alpha kff - K (x' - x)), one
        knot after another (ilqr.py:286-297); alpha (B,)."""
        x = X[..., 0]
        xs, us = [x], []
        a = alpha[..., None]
        for k in range(self.N - 1):
            u = U[..., k] - a * kff[:, k] - _matvec(K[:, k], x - X[..., k])
            x = self.plant.step(x, u, self.dt)
            xs.append(x)
            us.append(u)
        return torch.stack(xs, -1), torch.stack(us, -1)

    def _line_search(self, X, U, K, kff, dv1, dv2, J, cost_params, cstate,
                     done0):
        """The alpha ladder (ilqr.py:317-347): each scenario stops at its
        own rung; one that is ``done0`` on entry is never tried.  Returns
        (accepted, Xc, Uc, dJ, J_new)."""
        o = self.options
        false = torch.zeros_like(done0)
        s = dict(alpha=torch.ones_like(J), done=done0, accepted=false,
                 Xc=X, Uc=U, dJ=torch.zeros_like(J), J_new=J)
        while not bool(s["done"].all()):
            alpha = s["alpha"]
            Xc, Uc = self.rollout(X, U, K, kff, alpha)
            # cancellation-safe merit change: a difference, never two totals
            dJ = total_cost_diff(self.cost, self.cset, cstate, self.N,
                                 X, U, Xc, Uc, cost_params)
            # model reduction for u' = u - alpha kff:
            # J - J' ~ alpha Qu.kff - alpha^2/2 kff.Quu.kff (> 0 descent)
            expected = alpha * dv1 - 0.5 * alpha * alpha * dv2
            ratio = -dJ / expected
            ok = ((dJ <= 0)
                  & (ratio >= o.expected_reduction_min)
                  & (ratio <= o.expected_reduction_max))
            done = ok | ~(alpha > o.alpha_min)
            new = dict(alpha=torch.where(done, alpha, alpha * o.alpha_factor),
                       done=done, accepted=ok, Xc=Xc, Uc=Uc, dJ=dJ,
                       J_new=J + dJ)
            s = {k: _where(s["done"], s[k], v) for k, v in new.items()}
        return s["accepted"], s["Xc"], s["Uc"], s["dJ"], s["J_new"]

    # ----------------------------------------------------------- main loop
    def ilqr_round(self, X, U, cost_params, cstate, done0=None):
        """One inner iLQR solve (ilqr.py:299-396).  ``done0`` (B,) marks
        scenarios whose result the caller discards (the soft loop's
        finished ones): they start done and do no work.
        Returns (X, U, K, exit_code, iters, J)."""
        o = self.options
        nx, nu = self.plant.nx, self.plant.nu
        J0 = self.total_cost(X, U, cost_params, cstate)
        batch = J0.shape
        izero = torch.zeros(batch, dtype=torch.long, device=X.device)
        if done0 is None:
            done0 = torch.zeros(batch, dtype=torch.bool, device=X.device)
        s = dict(X=X, U=U, K=X.new_zeros(batch + (self.N - 1, nu, nx)),
                 J=J0, rho=torch.full_like(J0, o.rho_init),
                 drho=torch.ones_like(J0), it=izero, exit_code=izero,
                 done=done0)
        backward = (self.backward_parallel if self.parallel_riccati
                    else self.backward)
        # every live scenario exits by max_iter (hit_max), so the budget
        # bounds the loop exactly as the JAX while_loop's trip count
        for _ in range(o.max_iter):
            A, B, g, H, gN, HN = self._expansions(s["X"], s["U"],
                                                  cost_params, cstate)
            K, kff, dv1, dv2, bad_bp = backward(A, B, g, H, gN, HN, s["rho"])
            # Newton-decrement convergence: the model predicts no
            # meaningful reduction — stop before the line search thrashes
            converged = (dv1 < o.exit_tolerance) & ~bad_bp
            ls_ok, Xc, Uc, dJ, J_new = self._line_search(
                s["X"], s["U"], K, kff, dv1, dv2, s["J"], cost_params, cstate,
                s["done"] | bad_bp | converged)
            accepted = ls_ok & ~bad_bp & ~converged
            error = ~accepted
            rho, drho = s["rho"], s["drho"]
            drho_ok = (drho / o.rho_factor).clamp(max=1.0 / o.rho_factor)
            rho_ok = (rho * drho_ok).clamp(min=o.rho_min)
            drho_err = (drho * o.rho_factor).clamp(min=o.rho_factor)
            rho_err = (rho * drho_err).clamp(min=o.rho_min)
            rho1 = torch.where(accepted, rho_ok, rho_err)
            drho1 = torch.where(accepted, drho_ok, drho_err)
            # a converged iterate exits with EXIT_TOL; the forced
            # line-search rejection does not escalate rho on the way out
            rho1 = torch.where(converged, rho, rho1)
            drho1 = torch.where(converged, drho, drho1)
            exit_code = torch.where(error & (rho1 > o.rho_max),
                                    izero + EXIT_RHO_MAX, izero)
            exit_code = torch.where(~error & (-dJ < o.exit_tolerance),
                                    izero + EXIT_TOL, exit_code)
            exit_code = torch.where(converged, izero + EXIT_TOL, exit_code)
            # max-iter only when no other exit fired this iteration
            hit_max = s["it"] == (o.max_iter - 1)
            exit_code = torch.where(hit_max & (exit_code == 0),
                                    izero + EXIT_MAX_ITER, exit_code)
            done = exit_code > 0
            new = dict(X=_where(accepted, Xc, s["X"]),
                       U=_where(accepted, Uc, s["U"]), K=K,
                       J=torch.where(accepted, J_new, s["J"]), rho=rho1,
                       drho=drho1,
                       it=torch.where(done, s["it"], s["it"] + 1),
                       exit_code=exit_code, done=done)
            # batch-invariance freeze (ilqr.py:389-391)
            s = {k: _where(s["done"], s[k], v) for k, v in new.items()}
            if bool(s["done"].all()):
                break
        return s["X"], s["U"], s["K"], s["exit_code"], s["it"], s["J"]

    def _open_loop(self, x, U):
        """x_{k+1} = f(x_k, u_k) from x (B, nx): the N-1 states after x,
        (B, nx, N-1)."""
        xs = []
        for k in range(self.N - 1):
            x = self.plant.step(x, U[..., k], self.dt)
            xs.append(x)
        return torch.stack(xs, -1)

    # ----------------------------------------------------------- full solve
    def solve(self, x0, u0, cost_params=None, cstate=None) -> ILQRResult:
        """iLQR with the soft-constraint outer loop (soft only, per
        ref: README.md:17).  x0 (B, nx, N), u0 (B, nu, N-1); cost_params.xg
        (d,) or per-scenario (B, d)."""
        o = self.options
        if self.cset.has_hard():
            raise ValueError("iLQR supports soft constraints only "
                             "(ref: README.md:17)")
        cost_params = knot_params(self.cost.default_params
                                  if cost_params is None else cost_params)
        batch = x0.shape[:-2]
        if cstate is None:
            cstate = self.cset.init_state(dtype=x0.dtype, device=x0.device,
                                          batch=batch)
        # single shooting: roll the warm-start controls out from the first
        # state, so the initial trajectory is dynamically consistent
        Xtail = self._open_loop(x0[..., 0], u0)
        # plan reset (ilqr.py:411-433): a scenario whose warm rollout
        # diverges (non-finite, or |x| > 1e6) restarts from zero controls
        bad_plan = (~torch.isfinite(Xtail).flatten(-2).all(-1)
                    | (Xtail.abs().flatten(-2).amax(-1) > 1e6))
        if bool(bad_plan.any()):
            u0 = _where(bad_plan, torch.zeros_like(u0), u0)
            Xtail = _where(bad_plan, self._open_loop(x0[..., 0], u0), Xtail)
        x0 = torch.cat([x0[..., :1], Xtail], -1)

        nx, nu = self.plant.nx, self.plant.nu
        izero = torch.zeros(batch, dtype=torch.long, device=x0.device)
        s = dict(X=x0, U=u0, K=x0.new_zeros(batch + (self.N - 1, nu, nx)),
                 cstate=cstate, outer_it=izero, exit_soft=izero,
                 exit_ilqr=izero, iters=izero, J=x0.new_zeros(batch),
                 done=torch.zeros(batch, dtype=torch.bool, device=x0.device))
        for _ in range(o.max_iter_soft):
            X1, U1, K1, exit_ilqr, iters, J = self.ilqr_round(
                s["X"], s["U"], cost_params, s["cstate"], done0=s["done"])
            max_c = C.max_soft_violation(self.cset, s["cstate"], X1, U1)
            exit_soft = torch.where(max_c < o.exit_tolerance_soft,
                                    izero + EXIT_SOFT_CONVERGED, izero)
            hit_max = s["outer_it"] == (o.max_iter_soft - 1)
            exit_soft = torch.where(hit_max, izero + EXIT_SOFT_MAX_ITER,
                                    exit_soft)
            exiting = exit_soft > 0
            new_cstate, mu_at_limit = C.update_all_soft(self.cset, s["cstate"],
                                                        X1, U1)
            cstate1 = C.select_state(exiting, s["cstate"], new_cstate)
            exit_soft = torch.where(~exiting & mu_at_limit,
                                    izero + EXIT_SOFT_MU_LIMIT, exit_soft)
            done = exit_soft > 0
            new = dict(X=X1, U=U1, K=K1, exit_soft=exit_soft,
                       exit_ilqr=exit_ilqr, iters=iters, J=J, done=done,
                       outer_it=torch.where(hit_max | done, s["outer_it"],
                                            s["outer_it"] + 1))
            # batch-invariance freeze (ilqr.py:466-468), the soft state too
            new["cstate"] = C.select_state(s["done"], s["cstate"], cstate1)
            s = {k: v if k == "cstate" else _where(s["done"], s[k], v)
                 for k, v in new.items()}
            if bool(s["done"].all()):
                break
        return ILQRResult(X=s["X"], U=s["U"], K=s["K"],
                          exit_ilqr=s["exit_ilqr"], exit_soft=s["exit_soft"],
                          outer_iters=s["outer_it"], iters=s["iters"],
                          J=s["J"], cstate=s["cstate"])


def make_ilqr(plant: Plant, cost: Cost, cset: Optional[C.ConstraintSet],
              N: int, dt: float, options: Optional[SQPOptions] = None,
              parallel_riccati: bool = False) -> ILQRSolver:
    """Build an iLQR solver (ilqr.py:484-498; ref: README.md:17,
    MPCSolverMethods ``TrajoptMPCReference.py:21-27``).  parallel_riccati
    runs the backward pass as the log-depth scan.  Hard constraints raise
    ValueError in ``solve``, as in JAX."""
    if cset is None:
        cset = C.ConstraintSet(plant.nq, plant.nv, plant.nu, N)
    options = options or SQPOptions()
    return ILQRSolver(plant=plant, cost=cost, cset=cset, N=N, dt=dt,
                      options=options, parallel_riccati=parallel_riccati)
