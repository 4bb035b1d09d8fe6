"""Receding-horizon MPC loop over a batch of scenarios.

Port of trajoptmpcreference_tpu/solvers/mpc.py for every method: "iLQR",
"QP-N", "QP-S" and "QP-PCG-J" / "QP-PCG-BJ" / "QP-PCG-SS": each control step
re-solves the horizon problem warm-started from the shifted previous plan
(and, for the SQP methods, multipliers), applies the first control to the
simulated plant and advances.  The JAX ``lax.scan`` over control steps becomes a
Python loop; every tensor carries the scenario batch as its leading axis.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional, Union

import torch

from trajoptmpcreference_tpu_torch.models.plants import Plant
from trajoptmpcreference_tpu_torch.solvers import constraints as C
from trajoptmpcreference_tpu_torch.solvers.costs import Cost
from trajoptmpcreference_tpu_torch.solvers.ilqr import ILQRSolver, make_ilqr
from trajoptmpcreference_tpu_torch.solvers.sqp import (
    SQPOptions,
    SQPSolver,
    _where,
    make_sqp,
)

MPC_METHODS = ("iLQR", "QP-N", "QP-S", "QP-PCG-J", "QP-PCG-BJ", "QP-PCG-SS")


class MPCResult(NamedTuple):
    """Closed-loop episode results; the last axis runs over control steps."""

    X_applied: torch.Tensor    # (B, nx, steps+1) actual closed-loop states
    U_applied: torch.Tensor    # (B, nu, steps) applied first controls
    J_solve: torch.Tensor      # (B, steps) cost reported by each solve
    iters: torch.Tensor        # (B, steps) solver iterations per step
    exit_codes: torch.Tensor   # (B, steps) per-solve exit code
    X_plan_last: torch.Tensor  # (B, nx, N) final plan (warm-start state)
    U_plan_last: torch.Tensor  # (B, nu, N-1)
    cstate_last: Any           # final shifted soft-constraint state
    lam_last: torch.Tensor     # (B, N, nx + m) final shifted multipliers;
    #                            (B, 0) for iLQR, which has none


def _shift_plan(X, U, shift: int):
    """Receding-horizon warm start: drop the first ``shift`` knots, repeat
    the terminal knot / last control (torch.roll matches jnp.roll)."""
    Xs = torch.roll(X, -shift, dims=-1)
    Us = torch.roll(U, -shift, dims=-1)
    NX, NU = X.shape[-1], U.shape[-1]
    colsX = torch.arange(NX, device=X.device)
    colsU = torch.arange(NU, device=U.device)
    Xs = torch.where(colsX < NX - shift, Xs, X[..., -1:])
    Us = torch.where(colsU < NU - shift, Us, U[..., -1:])
    return Xs, Us


@dataclasses.dataclass(frozen=True)
class MPCController:
    """A receding-horizon controller around an SQP or iLQR solver."""

    solver: Union[SQPSolver, ILQRSolver]
    sim_plant: Plant          # the "true" plant used to propagate the state
    shift: int = 1
    # plan watchdog (mpc.py:77-86): a non-finite plan or a first control
    # beyond this bound applies zero control for the step and cold-resets
    # the warm-start carry (plan, multipliers, soft-constraint state).
    # inf = off (reference parity).
    watchdog_u_max: float = float("inf")
    # joint velocity limit of the simulated plant (the port's own; inf =
    # off, as the reference): each simulated state's joint velocities are
    # clamped to +-sim_qd_max.  NaN passes through.
    sim_qd_max: float = float("inf")

    @property
    def plant(self) -> Plant:
        return self.solver.plant

    def run(self, x0: torch.Tensor, steps: int,
            X_init: Optional[torch.Tensor] = None,
            U_init: Optional[torch.Tensor] = None,
            cost_params: Any = None,
            cstate_init: Any = None,
            lam_init: Optional[torch.Tensor] = None) -> MPCResult:
        """Simulate ``steps`` control steps of closed-loop MPC from the
        states x0 (B, nx).  ``X_init`` / ``U_init`` / ``cstate_init`` /
        ``lam_init`` seed the warm-start carry (run_scheduled's hooks)."""
        solver = self.solver
        N, dt = solver.N, solver.dt
        nu = self.plant.nu
        B = x0.shape[:-1]
        is_sqp = isinstance(solver, SQPSolver)
        Xp = x0[..., None].expand(*x0.shape, N) if X_init is None else X_init
        Up = x0.new_zeros(B + (nu, N - 1)) if U_init is None else U_init
        # fresh soft-constraint state, also what the watchdog resets to
        fresh = solver.cset.init_state(dtype=x0.dtype, device=x0.device,
                                       batch=B)
        cstate = fresh if cstate_init is None else cstate_init
        if lam_init is not None:
            lam = lam_init
        else:
            lam = x0.new_zeros(B + ((N, solver.kkt.bs) if is_sqp else (0,)))
        rows = torch.arange(N, device=x0.device)
        x = x0
        xs_, us_, Js, its, codes = [], [], [], [], []
        for _ in range(steps):
            # the current state enters the plan head
            Xp = Xp.clone()
            Xp[..., :, 0] = x
            if is_sqp:
                res = solver.solve(Xp, Up, cost_params=cost_params,
                                   cstate=cstate, guess=lam)
                it, code = res.sqp_iters, res.exit_sqp
                # shift the multipliers like the plan and zero-fill the
                # vacated tail rows (mpc.py:145-154)
                lam = torch.roll(res.lam, -self.shift, dims=-2)
                lam = torch.where((rows < N - self.shift)[:, None], lam,
                                  torch.zeros_like(lam))
            else:
                # iLQR: no multiplier warm start; the lam carry passes
                # through (mpc.py:131-134)
                res = solver.solve(Xp, Up, cost_params=cost_params,
                                   cstate=cstate)
                it, code = res.iters, res.exit_ilqr
            u0 = res.U[..., :, 0]
            Xp, Up = _shift_plan(res.X, res.U, self.shift)
            cstate = C.shift_all_soft(solver.cset, res.cstate, self.shift)
            if math.isfinite(self.watchdog_u_max):
                bad = (~torch.isfinite(res.U).flatten(-2).all(-1)
                       | ~torch.isfinite(res.X).flatten(-2).all(-1)
                       | (u0.abs().amax(-1) > self.watchdog_u_max))
                u0 = _where(bad, torch.zeros_like(u0), u0)
                Xp = _where(bad, x[..., None].expand_as(Xp), Xp)
                Up = _where(bad, torch.zeros_like(Up), Up)
                lam = _where(bad, torch.zeros_like(lam), lam)
                cstate = C.select_state(bad, fresh, cstate)
            x = self.sim_plant.step(x, u0, dt)
            if math.isfinite(self.sim_qd_max):
                nq = self.sim_plant.nq
                x = torch.cat([x[..., :nq], x[..., nq:].clamp(
                    -self.sim_qd_max, self.sim_qd_max)], dim=-1)
            xs_.append(x)
            us_.append(u0)
            Js.append(res.J)
            its.append(it)
            codes.append(code)
        return MPCResult(X_applied=torch.stack([x0] + xs_, dim=-1),
                         U_applied=torch.stack(us_, dim=-1),
                         J_solve=torch.stack(Js, dim=-1),
                         iters=torch.stack(its, dim=-1),
                         exit_codes=torch.stack(codes, dim=-1),
                         X_plan_last=Xp, U_plan_last=Up,
                         cstate_last=cstate, lam_last=lam)


def run_scheduled(phases, x0: torch.Tensor, cost_params: Any = None
                  ) -> MPCResult:
    """Chain MPC phases with different solver budgets over one episode
    (mpc.py:183-226).  ``phases`` is a sequence of ``(controller, steps)``
    pairs over the same problem; each phase starts from the previous
    phase's closed-loop state and inherits its warm-start carry (plan,
    soft-constraint state, multipliers)."""
    res = None
    parts = []
    x = x0
    for ctrl, steps in phases:
        kw = {}
        if res is not None:
            kw = dict(X_init=res.X_plan_last, U_init=res.U_plan_last,
                      cstate_init=res.cstate_last, lam_init=res.lam_last)
        res = ctrl.run(x, steps=steps, cost_params=cost_params, **kw)
        parts.append(res)
        x = res.X_applied[..., -1]
    cat = lambda name: torch.cat([getattr(p, name) for p in parts], dim=-1)
    return MPCResult(
        X_applied=torch.cat([parts[0].X_applied]
                            + [p.X_applied[..., 1:] for p in parts[1:]], dim=-1),
        U_applied=cat("U_applied"), J_solve=cat("J_solve"),
        iters=cat("iters"), exit_codes=cat("exit_codes"),
        X_plan_last=res.X_plan_last, U_plan_last=res.U_plan_last,
        cstate_last=res.cstate_last, lam_last=res.lam_last)


def make_mpc(plant: Plant, cost: Cost, cset: Optional[C.ConstraintSet],
             N: int, dt: float, method: str = "QP-S",
             options: Optional[SQPOptions] = None,
             sim_plant: Optional[Plant] = None,
             shift: int = 1, use_kernel_pcg: bool = False) -> MPCController:
    """Build a receding-horizon MPC controller (ref:
    TrajoptMPCReference.py:21-27; mpc.py:229-260): 'iLQR', or 'QP-' and
    an SQP method; use_kernel_pcg goes to make_sqp."""
    from trajoptmpcreference_tpu_torch.solvers.methods import method_str
    method = method_str(method)
    if method not in MPC_METHODS:
        raise ValueError(f"Invalid MPC method {method!r}; options are "
                         f"{MPC_METHODS} (ref: TrajoptMPCReference.py:21-27)")
    if options is None:
        # the reference's own example disables the lower reduction-ratio
        # bound (ref: examples/twolinks.py:87)
        options = SQPOptions(expected_reduction_min=-100.0)
    if method == "iLQR":
        solver = make_ilqr(plant, cost, cset, N, dt, options=options)
    else:
        solver = make_sqp(plant, cost, cset, N, dt, method=method[3:],
                          options=options, use_kernel_pcg=use_kernel_pcg)
    return MPCController(solver=solver, sim_plant=sim_plant or plant,
                         shift=shift)
