"""One closed-loop MPC step of the configurations, in plain PyTorch.

The step the benchmark judges: the current state enters the plan's first
knot, a fixed budget of SQP iterations improves the plan (task-space cost,
dynamics as equality rows, optional box limits on the torques kept as
ACTIVE_SET rows), the first control is applied to the simulated arm, and
the plan and the multipliers are shifted one knot for the next step.

Each SQP iteration linearizes the problem at the current iterate, solves
the KKT system of the Newton step by one dense Schur complement per
scenario (the whole (N (nx + m))^2 matrix, no block structure exploited),
tries the step lengths of the ladder on an L1 merit function and keeps the
first that passes; a scenario that has converged keeps its iterate.  The
rules for acceptance, the regularization schedule and the exits are those
of the configuration's ``solver`` section (the reference's own
TrajoptMPCReference.py:510-760, as the configuration states them).

X (B, nx, N) and U (B, nu, N-1) as the program takes them; every function
works on a block of scenarios at a time so that the dense systems fit.
"""

from __future__ import annotations

import dataclasses

import torch

from reference.arm import PlanarArm

EXIT_TOL, EXIT_RHO_MAX, EXIT_MAX_ITER = 1, 2, 3


@dataclasses.dataclass
class StepResult:
    X_plan: torch.Tensor   # (B, nx, N) the solved plan, shifted one knot
    U_plan: torch.Tensor   # (B, nu, N-1)
    lam: torch.Tensor      # (B, N, nx + m) multipliers, shifted one knot
    u0: torch.Tensor       # (B, nu) the applied control
    x1: torch.Tensor       # (B, nx) the next simulated state
    iters: torch.Tensor    # (B,) SQP iterations taken


class Problem:
    """The horizon problem of one configuration, in ``dtype`` on ``device``."""

    def __init__(self, cfg: dict, dtype, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.arm = PlanarArm(cfg["robot"], cfg["dt"], cfg["sim_qd_max"])
        self.N = int(cfg["horizon"])
        self.nx, self.nu = self.arm.nx, self.arm.nu
        self.n = self.nx + self.nu
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=self.device)
        c = cfg["cost"]
        self.Q = torch.diag(t(c["Q_diag"]))
        self.QF = c["qf"] * torch.eye(len(c["Q_diag"]), dtype=dtype,
                                      device=self.device)
        self.r = float(c["r"])
        lim = cfg.get("torque_limit", 0.0)
        self.m = 2 * self.nu if lim > 0 else 0
        self.lo, self.hi = -float(lim), float(lim)

    # ------------------------------------------------------------ pieces
    def _hard(self, U):
        """Masked torque rows at the stage knots: values (B, K, m), active
        (B, K, m); the margins [u - lo; hi - u], live where violated."""
        marg = torch.cat([U - self.lo, self.hi - U], dim=-1)
        act = marg < 0.0
        return torch.where(act, marg, torch.zeros_like(marg)), act

    def _residual(self, Xk, xg):
        """Task-space residual (…, N, 6) of knot states (…, N, nx)."""
        return self.arm.task(Xk) - xg

    def _weights(self, K):
        """(K, 6, 6): Q on the stage knots, QF on the last."""
        W = self.Q.expand(K, 6, 6).clone()
        W[-1] = self.QF
        return W

    def cost_diff(self, Xk, Uk, Xck, Uck, xg):
        """J(candidate) - J(base) per scenario, summed stage by stage in
        the residual form 0.5 (rc - r)' W (rc + r), which keeps f32 from
        cancelling two large totals."""
        W = self._weights(self.N)
        r, rc = self._residual(Xk, xg), self._residual(Xck, xg)
        dx = 0.5 * torch.einsum("...ka,kab,...kb->...k", rc - r, W, rc + r)
        du = 0.5 * self.r * ((Uck - Uk) * (Uck + Uk)).sum(-1)
        return dx.sum(-1) + du.sum(-1)

    def cost(self, Xk, Uk, xg):
        W = self._weights(self.N)
        r = self._residual(Xk, xg)
        return (0.5 * torch.einsum("...ka,kab,...kb->...", r, W, r)
                + 0.5 * self.r * (Uk * Uk).sum((-1, -2)))

    def violation(self, Xk, Uk, xs):
        """L1 norm of the initial-state and dynamics defects plus the live
        torque rows."""
        pred = self.arm.step(Xk[..., :-1, :], Uk)
        c = ((Xk[..., 1:, :] - pred).abs().sum((-1, -2))
             + (Xk[..., 0, :] - xs).abs().sum(-1))
        if self.m:
            c = c + self._hard(Uk)[0].abs().sum((-1, -2))
        return c

    # --------------------------------------------------------- the QP
    def newton_step(self, Xk, Uk, xs, xg, rho):
        """Gradient g (B, N, n) and the KKT solution (dxu (B, N, n), lam
        (B, N, nx + m)) at the iterate, the step being -dxu.  The terminal
        knot carries phantom controls with a unit Hessian."""
        N, nx, nu, n, m = self.N, self.nx, self.nu, self.n, self.m
        Bsz = Xk.shape[0]
        dt, dev = Xk.dtype, Xk.device
        bs = nx + m
        # cost: Gauss-Newton Hessian of the task-space residual
        W = self._weights(N)
        r = self._residual(Xk, xg)                          # (B, N, 6)
        Jt = self.arm.task_jacobian(Xk)                     # (B, N, 6, nx)
        WJ = W @ Jt
        g = torch.zeros(Bsz, N, n, dtype=dt, device=dev)
        g[..., :nx] = (r[..., None, :] @ WJ)[..., 0, :]
        g[..., :-1, nx:] = self.r * Uk
        H = torch.zeros(Bsz, N, n, n, dtype=dt, device=dev)
        H[..., :nx, :nx] = Jt.transpose(-1, -2) @ WJ
        eye_n = torch.eye(n, dtype=dt, device=dev)
        G = H + rho[:, None, None, None] * eye_n
        G[..., :-1, nx:, nx:] += self.r * torch.eye(nu, dtype=dt, device=dev)
        G[..., -1, nx:, :] = eye_n[nx:]                     # phantom controls
        G[..., -1, :nx, nx:] = 0.0
        # constraints: row group k = [defect_k (nx); torque rows_k (m)]
        A, Bm = self.arm.step_jacobians(Xk[..., :-1, :], Uk)
        pred = self.arm.step(Xk[..., :-1, :], Uk)
        defect = torch.cat([(Xk[..., 0, :] - xs)[:, None],
                            Xk[..., 1:, :] - pred], dim=1)
        R, T = N * bs, N * n
        C = torch.zeros(Bsz, R, T, dtype=dt, device=dev)
        rhs = torch.zeros(Bsz, N, bs, dtype=dt, device=dev)
        Dg = torch.zeros(Bsz, N, bs, dtype=dt, device=dev)
        rhs[..., :nx] = defect
        Cv = C.view(Bsz, N, bs, N, n)
        ks = torch.arange(N, device=dev)
        Cv[:, ks, :nx, ks, :nx] = torch.eye(nx, dtype=dt, device=dev)
        Cv[:, ks[1:], :nx, ks[:-1], :] = -torch.cat([A, Bm], dim=-1).transpose(0, 1)
        if m:
            hval, act = self._hard(Uk)                      # (B, N-1, m)
            sel = torch.cat([torch.eye(nu, dtype=dt, device=dev),
                             -torch.eye(nu, dtype=dt, device=dev)])   # (m, nu)
            hj = torch.where(act[..., None], sel, torch.zeros_like(sel))
            Cv[:, ks[:-1], nx:, ks[:-1], nx:] = hj.transpose(0, 1)
            rhs[..., :-1, nx:] = hval
            live = torch.zeros(Bsz, N, m, dtype=torch.bool, device=dev)
            live[..., :-1, :] = act
            Dg[..., nx:] = torch.where(live, 0.0, -1.0)
        # S lam = gam, S = D - C G^-1 C^T, gam = rhs - C G^-1 g, all dense
        Gi = torch.linalg.inv(G)                            # (B, N, n, n)
        CGi = torch.einsum("brkn,bknm->brkm", C.view(Bsz, R, N, n),
                           Gi).reshape(Bsz, R, T)
        S = torch.diag_embed(Dg.reshape(Bsz, R)) - CGi @ C.transpose(-1, -2)
        gam = rhs.reshape(Bsz, R) - (CGi @ g.reshape(Bsz, T, 1))[..., 0]
        lam = torch.linalg.solve(S, gam)
        resid = g.reshape(Bsz, T) - (C.transpose(-1, -2) @ lam[..., None])[..., 0]
        dxu = (Gi @ resid.view(Bsz, N, n, 1))[..., 0]
        return g, dxu, lam.view(Bsz, N, bs)

    # ------------------------------------------------------------ SQP
    def solve(self, X, U, xg, knobs: dict):
        """The SQP iterations of one control step from the plan (X, U)
        (X's first knot is the current state).  Returns (X, U, lam,
        iters)."""
        o = self.cfg["solver"]
        Xk, Uk = X.transpose(-1, -2), U.transpose(-1, -2)
        xs = Xk[..., 0, :].clone()
        Bsz = Xk.shape[0]
        dt, dev = Xk.dtype, Xk.device
        ladder = [1.0]
        while ladder[-1] > knobs["alpha_min"]:
            ladder.append(ladder[-1] * knobs["alpha_factor"])
        alphas = torch.tensor(ladder, dtype=dt, device=dev)
        mu = float(o["merit_mu"])
        J = self.cost(Xk, Uk, xg)
        c = self.violation(Xk, Uk, xs)
        merit = J + mu * c
        rho = torch.full((Bsz,), float(knobs["rho_init"]), dtype=dt, device=dev)
        drho = torch.ones_like(rho)
        it = torch.zeros(Bsz, dtype=torch.long, device=dev)
        done = torch.zeros(Bsz, dtype=torch.bool, device=dev)
        lam = torch.zeros(Bsz, self.N, self.nx + self.m, dtype=dt, device=dev)
        max_iter = int(knobs["max_iter"])
        for _ in range(max_iter):
            hit_max = it == max_iter - 1
            g, dxu, lam_new = self.newton_step(Xk, Uk, xs, xg, rho)
            D = (g * dxu).sum((-1, -2))       # Armijo derivative at the base
            dX, dU = dxu[..., :self.nx], dxu[..., :-1, self.nx:]
            a = alphas[:, None, None, None]
            Xc, Uc = Xk - a * dX, Uk - a * dU                 # (K, B, …)
            dJ = self.cost_diff(Xk, Uk, Xc, Uc, xg)           # (K, B)
            c_new = self.violation(Xc, Uc, xs)
            dmerit = -dJ + mu * (c - c_new)
            ratio = dmerit / (alphas[:, None] * (D - mu * c_new))
            ok = ((dmerit >= 0) & (ratio >= o["expected_reduction_min"])
                  & (ratio <= o["expected_reduction_max"]))
            K = len(ladder)
            idx = torch.where(ok.any(0), ok.int().argmax(0),
                              torch.full_like(it, K - 1))
            pick = lambda v: v.gather(0, idx[None])[0]
            acc = pick(ok)
            al = alphas[idx]
            X1 = torch.where(acc[:, None, None], Xk - al[:, None, None] * dX, Xk)
            U1 = torch.where(acc[:, None, None], Uk - al[:, None, None] * dU, Uk)
            J1 = torch.where(acc, J + pick(dJ), J)
            c1 = torch.where(acc, pick(c_new), c)
            merit1 = torch.where(acc, merit - pick(dmerit), merit)
            f = float(o["rho_factor"])
            drho_ok = (drho / f).clamp(max=1.0 / f)
            rho_ok = (rho * drho_ok).clamp(min=knobs["rho_min"])
            drho_err = (drho * f).clamp(min=f)
            rho_err = (rho * drho_err).clamp(min=knobs["rho_min"])
            rho1 = torch.where(acc, rho_ok, rho_err)
            drho1 = torch.where(acc, drho_ok, drho_err)
            code = torch.where(~acc & (rho1 > o["rho_max"]), EXIT_RHO_MAX, 0)
            code = torch.where(acc & (-pick(dJ) < o["exit_tolerance"]),
                               EXIT_TOL, code)
            code = torch.where(hit_max & (code == 0), EXIT_MAX_ITER, code)
            now = code > 0
            keep = lambda old, new: torch.where(
                done.reshape(done.shape + (1,) * (new.dim() - 1)), old, new)
            Xk, Uk = keep(Xk, X1), keep(Uk, U1)
            J, c, merit = keep(J, J1), keep(c, c1), keep(merit, merit1)
            rho, drho = keep(rho, rho1), keep(drho, drho1)
            lam = keep(lam, lam_new)
            it = keep(it, torch.where(now, it, it + 1))
            done = done | now
        return Xk.transpose(-1, -2), Uk.transpose(-1, -2), lam, it


def shift(X, U, lam):
    """Drop the first knot: the plan's last knot and control repeat, the
    multipliers' vacated last row is zero."""
    Xs = torch.cat([X[..., 1:], X[..., -1:]], dim=-1)
    Us = torch.cat([U[..., 1:], U[..., -1:]], dim=-1)
    lams = torch.cat([lam[..., 1:, :], torch.zeros_like(lam[..., :1, :])], dim=-2)
    return Xs, Us, lams


def mpc_step(prob: Problem, x, goals, knobs: dict, X_init=None, U_init=None,
             block: int = 256) -> StepResult:
    """One control step for states x (B, nx) and goals (B, 6); without a
    plan the step starts cold (the state held over the horizon, zero
    controls).  Scenarios go ``block`` at a time."""
    parts = []
    N, nu = prob.N, prob.nu
    for i in range(0, x.shape[0], block):
        xb, gb = x[i:i + block], goals[i:i + block]
        if X_init is None:
            Xp = xb[..., None].expand(xb.shape + (N,)).clone()
            Up = xb.new_zeros(xb.shape[0], nu, N - 1)
        else:
            Xp, Up = X_init[i:i + block].clone(), U_init[i:i + block]
            Xp[..., 0] = xb
        X, U, lam, iters = prob.solve(Xp, Up, gb[:, None, :], knobs)
        u0 = U[..., 0]
        Xs, Us, lams = shift(X, U, lam)
        parts.append(StepResult(Xs, Us, lams, u0,
                                prob.arm.simulate(xb, u0), iters))
    return StepResult(*(torch.cat([getattr(p, f.name) for p in parts])
                        for f in dataclasses.fields(StepResult)))
