"""Per-iteration SQP traces.

Port of trajoptmpcreference_tpu/utils/trace.py.  The reference keeps a
per-iteration dict trace (ref: TrajoptMPCReference.py:555-569,691-705);
here ``solve_traced`` runs the solver's own iteration body
(``SQPSolver.sqp_iterate``, after its own ``base_metrics``), so the trace
cannot drift from the solver it traces, and writes one row per
iteration: fields (..., max_iter) over the scenario batch, the shape of
the reference's RETURN_TRACE_SQP output.

A scenario is frozen after the iteration in which it exits, as in
``SQPSolver.sqp_round``; its later rows stay zero (``live`` False), as in
the JAX trace.  Like ``sqp_round``, the loop ends once every scenario has
exited: the rows of the iterations it skips would all be zero.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from trajoptmpcreference_tpu_torch.solvers.sqp import SQPSolver, knot_params


class SQPTrace(NamedTuple):
    """Per-iteration history, (..., max_iter) per field; rows past a
    scenario's exit iteration are zero.  Fields mirror the reference's
    trace dict (ref: TrajoptMPCReference.py:555-569)."""

    J: torch.Tensor                # cost
    c: torch.Tensor                # violation (defects and hard rows)
    merit: torch.Tensor
    alpha: torch.Tensor            # accepted (or last tried) step
    rho: torch.Tensor
    D: torch.Tensor                # directional derivative
    reduction_ratio: torch.Tensor
    pcg_iters: torch.Tensor        # long
    accepted: torch.Tensor         # bool: the line search succeeded
    live: torch.Tensor             # bool: the row is a real iteration
    exit_code: torch.Tensor        # (...,) long
    iters: torch.Tensor            # (...,) iterations run, the exiting one included
    # the PCG dual trace of each SQP iteration, (..., max_iter,
    # max_iter_linSys + 1): |nu| and the true |gamma - S lam| histories
    # (ref: GBD-PCG-Python/PCG.py:82-95); set only when options.trace_linsys
    # is on for a PCG method without use_kernel_pcg, else None
    pcg_nu: Optional[torch.Tensor] = None
    pcg_resid: Optional[torch.Tensor] = None


def solve_traced(solver: SQPSolver, x0, u0, cost_params=None, cstate=None):
    """One SQP round with tracing (the soft-constraint outer loop is not
    included: trace one round per outer update, as the reference does).
    x0 (..., nx, N), u0 (..., nu, N-1), cost_params as ``solver.solve``
    takes them.  Returns (X, U, SQPTrace)."""
    o = solver.options
    cost_params = knot_params(solver.cost.default_params
                              if cost_params is None else cost_params)
    batch, dtype, dev = x0.shape[:-2], x0.dtype, x0.device
    if cstate is None:
        cstate = solver.cset.init_state(dtype=dtype, device=dev, batch=batch)
    xs = x0[..., :, 0]
    max_iter = o.max_iter
    J0, c0 = solver.base_metrics(x0, u0, xs, cost_params, cstate)
    mu = solver.merit_weight(J0, c0)
    long = dict(dtype=torch.long, device=dev)
    s = dict(X=x0, U=u0, J=J0, c=c0, merit=J0 + mu * c0,
             rho=torch.full_like(J0, o.rho_init), drho=torch.ones_like(J0),
             done=torch.zeros(batch, dtype=torch.bool, device=dev),
             guess=x0.new_zeros(batch + (solver.N, solver.kkt.bs)))
    exit_code = torch.zeros(batch, **long)
    iters = torch.zeros(batch, **long)
    with_linsys = (o.trace_linsys and solver.method.startswith("PCG")
                   and not solver.kkt.use_kernel_pcg)
    rows = {name: [] for name in SQPTrace._fields[:10]}
    lin = {"pcg_nu": [], "pcg_resid": []}
    for it in range(max_iter):
        hit_max = torch.full(batch, it == max_iter - 1, dtype=torch.bool,
                             device=dev)
        (X1, U1, J1, c1, merit1, rho1, drho1, code, lam, ls,
         stats) = solver.sqp_iterate(s["X"], s["U"], s["J"], s["c"],
                                     s["merit"], s["rho"], s["drho"],
                                     s["guess"], mu, xs, cost_params, cstate,
                                     hit_max)
        live = ~s["done"]
        live_or_0 = lambda v: torch.where(live, v, torch.zeros_like(v))
        for name, v in (("J", J1), ("c", c1), ("merit", merit1),
                        ("alpha", ls.alpha), ("rho", rho1), ("D", ls.D),
                        ("reduction_ratio", ls.ratio),
                        ("pcg_iters", stats.pcg_iters.long())):
            rows[name].append(live_or_0(v))
        rows["accepted"].append(ls.accepted & live)
        rows["live"].append(live)
        if with_linsys:
            for name, v in (("pcg_nu", stats.nu_trace),
                            ("pcg_resid", stats.res_trace)):
                lin[name].append(torch.where(live[..., None], v,
                                             torch.zeros_like(v)))
        exiting = code > 0
        exit_code = torch.where(live & exiting, code, exit_code)
        iters = torch.where(live, iters.new_full((), it + 1), iters)
        keep = live & ~exiting
        m = lambda t: live.reshape(live.shape + (1,) * (t.dim() - live.dim()))
        s = dict(X=torch.where(m(X1), X1, s["X"]),
                 U=torch.where(m(U1), U1, s["U"]),
                 J=torch.where(live, J1, s["J"]), c=torch.where(live, c1, s["c"]),
                 merit=torch.where(live, merit1, s["merit"]),
                 rho=torch.where(keep, rho1, s["rho"]),
                 drho=torch.where(keep, drho1, s["drho"]),
                 done=s["done"] | exiting,
                 guess=torch.where(m(lam), lam, s["guess"]))
        if bool(s["done"].all()):
            break

    def stack(vs):
        # the rows of the iterations not run: every scenario had exited
        pad = [torch.zeros_like(vs[0])] * (max_iter - len(vs))
        return torch.stack(vs + pad, dim=len(batch))

    trace = SQPTrace(**{name: stack(v) for name, v in rows.items()},
                     exit_code=exit_code, iters=iters,
                     **({name: stack(v) for name, v in lin.items()}
                        if with_linsys else {}))
    return s["X"], s["U"], trace
