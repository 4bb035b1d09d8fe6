"""How ``correct`` is decided: the kept steps of the timed path against
the plain reference (``benchmark/reference``), in float64.

The reference cannot replay a whole closed loop: two loops part by
rounding over many steps.  So it follows the program step by step: for
each kept step it takes the program's state and warm start at that step
(the step's inputs: plan and multipliers), solves the step itself by the
configuration's own solver path and shifts its own plan and multipliers,
and the program's outputs (shifted plan, shifted multipliers, applied
control, next state) are judged against its.  The window's first step
starts cold from the benchmark's own scenarios and takes nothing from the
program; the steady steps are judged by the merit each solve gains from
its starting plan, against the reference's gain from the same plan, and
by their multipliers; the next state, by simulating the program's applied
control.  The multiplier warm start is an input like the plan: the exact
Schur solves (method S) never read it, the PCG path (method PCG-SS)
starts its first SQP iteration's PCG from it, so a PCG cell's steady
multipliers show whether the program took it.

A scenario-step runs away when the state it starts from turns a joint
at half the simulated joint speed limit or faster (``loop.RUNAWAY_QD``).
There the float64 reference finds no step that lowers the merit, and a
float32 solve, the program's or the reference's own, may raise a merit of
up to 1e6 by a third: one such step outweighs the summed gains of the
rest.  So the steady numbers (``steady_gain_deficit_tame``,
``lam_steady_p75``) leave run-away steps out; they are judged by the next
state and by finiteness.  The starting state is the same input for the
program and the reference, so no answer moves itself out of the judged
set; ``runaway_share``, the share of every scenario-step of the window
that runs away, keeps a fault from hiding among run-aways.

Every answer has to be finite: a kept scenario-step in which any output
of the answer (plan, multipliers, applied control, next state) is not
finite counts for ``nonfinite_share``, which every cell holds at 0
(``REQUIRED``), whatever its limits file names.  A statistic over the
steps cannot see them: a percentile passes a few infinite gaps, and a
step fed a non-finite warm start leaves the reference as stuck as the
program, so neither gains merit.

The reference is the module that the configuration names under
``"reference"`` (``sqp`` without the key), a file of
``benchmark/reference/`` loaded by its path.  It provides:

* ``Problem(config, dtype, device)`` with ``.arm.simulate(x, u)`` (the
  simulated next state, joint speeds clamped to ``sim_qd_max``),
  ``.cost(Xk, Uk, xg)`` and ``.violation(Xk, Uk, xs)`` (per scenario, on
  knot-major plans (B, N, nx) and (B, N-1, nu)), and ``.N``, ``.nx``,
  ``.nu``; the state is [q; qd], the joint speeds its second half;
* ``mpc_step(prob, x, goals, knobs, X_init, U_init, lam_init, block)``:
  one control step from the states x (B, nx), the goals (B, 6) and the
  warm start (None for a cold step), returning ``X_plan``, ``U_plan``,
  ``lam`` (shifted), ``u0`` and ``x1``.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional

import numpy as np
import torch

from benchlib import manifest
from benchlib.loop import Sample, runaway

# the numbers every cell compares, beside those its limits file names
REQUIRED = {"nonfinite_share": 0.0}


@functools.lru_cache(maxsize=None)
def _load_reference(path):
    return manifest.load_module(path, "reference_")


def reference_module(config: dict, bench_dir=manifest.HERE):
    """The reference module the configuration names (``sqp`` without the
    ``reference`` key), loaded from ``<bench_dir>/reference/`` by path."""
    return _load_reference(bench_dir / "reference"
                           / f"{config.get('reference', 'sqp')}.py")


def _max_abs(a, b):
    return (a - b).abs().flatten(1).amax(1)


def reference_answers(samples: List[Sample], config: dict, dtype, device,
                      block: int = 256) -> List[dict]:
    """The reference's own step from each sample's inputs, in ``dtype``
    (float64 for the reference, float32 for its control).  Samples of one
    phase (cold or steady) are solved together as one batch."""
    ref = reference_module(config)
    prob = ref.Problem(config, dtype, device)
    out = [None] * len(samples)
    for cold in (True, False):
        idx = [i for i, s in enumerate(samples) if s.cold == cold]
        if not idx:
            continue
        cat = lambda name: (None if getattr(samples[idx[0]], name) is None
                            else torch.cat([getattr(samples[i], name)
                                            for i in idx]).to(dtype))
        knobs = config["cold_knobs"] if cold else config["knobs"]
        r = ref.mpc_step(prob, cat("x"), cat("goals"), knobs, cat("X_init"),
                         cat("U_init"), cat("lam_init"), block=block)
        start = 0
        for i in idx:
            b = samples[i].x.shape[0]
            sl = slice(start, start + b)
            out[i] = dict(X_plan=r.X_plan[sl], U_plan=r.U_plan[sl],
                          lam=r.lam[sl], u0=r.u0[sl], x1=r.x1[sl])
            start += b
    return out


def gaps(samples: List[Sample], answers: List[dict], truth: List[dict],
         config: dict, window_runaway: Optional[List[torch.Tensor]] = None
         ) -> Dict[str, np.ndarray]:
    """Per scenario-step gaps of ``answers`` (the program's outputs, or
    the control's) to ``truth`` (the reference's).  The next state is
    held against the reference's simulation of the answer's own applied
    control.  ``nonfinite`` marks the scenario-steps in which an output of
    the answer is not finite, ``runaway`` those that start from a run-away
    state; ``runaway_window`` is the window's own run-away flags, every
    scenario of every step (``Window.runaway``)."""
    prob = reference_module(config).Problem(config, torch.float64,
                                            samples[0].x.device)
    arm = prob.arm
    mu = float(config["solver"]["merit_mu"])

    def plan_merit(s, X, U):
        Xk, Uk = X.transpose(-1, -2), U.transpose(-1, -2)
        xg = s.goals.double()[:, None, :]
        return (prob.cost(Xk, Uk, xg)
                + mu * prob.violation(Xk, Uk, s.x.double()))

    def merit(s, a):
        # the answer's unshifted plan: the state at the step, then the
        # shifted plan's knots; the applied control, then the rest
        X = torch.cat([s.x.double()[..., None], a["X_plan"].double()[..., :-1]], -1)
        U = torch.cat([a["u0"].double()[..., None], a["U_plan"].double()[..., :-1]], -1)
        return plan_merit(s, X, U)

    def start_merit(s):
        # the plan the step starts from: the warm start with the state in
        # its first knot, or (cold) the state held and zero controls
        if s.X_init is None:
            X = s.x.double()[..., None].expand(s.x.shape + (prob.N,))
            U = s.x.new_zeros(s.x.shape[0], prob.nu, prob.N - 1).double()
        else:
            X = s.X_init.double().clone()
            X[..., 0] = s.x.double()
            U = s.U_init.double()
        return plan_merit(s, X, U)

    cols = {k: [] for k in ("lam", "lam_scale", "x1", "cold", "merit_excess",
                            "gain", "gain_ref", "nonfinite", "runaway")}
    for s, a, t in zip(samples, answers, truth):
        f = lambda v: v.double()
        m_t, m_a, m_0 = merit(s, t), merit(s, a), start_merit(s)
        cols["merit_excess"].append((m_a - m_t) / m_t.clamp(min=1e-12))
        cols["gain"].append(m_0 - m_a)
        cols["gain_ref"].append(m_0 - m_t)
        cols["lam"].append(_max_abs(f(a["lam"]), f(t["lam"])))
        x1 = arm.simulate(f(s.x), f(a["u0"]))
        cols["x1"].append(((f(a["x1"]) - x1).abs() / (1.0 + x1.abs()))
                          .flatten(1).amax(1))
        cols["lam_scale"].append(f(t["lam"]).abs().flatten(1).amax(1))
        cols["cold"].append(torch.full_like(cols["x1"][-1], float(s.cold)))
        finite = torch.stack([torch.isfinite(a[k]).flatten(1).all(1) for k in
                              ("X_plan", "U_plan", "lam", "u0", "x1")]).all(0)
        cols["nonfinite"].append((~finite).double())
        cols["runaway"].append(runaway(s.x, config).double())
    if window_runaway is not None:
        cols["runaway_window"] = [t.double().flatten() for t in window_runaway]
    return {k: torch.cat(v).cpu().numpy() for k, v in cols.items()}


def program_answers(samples: List[Sample]) -> List[dict]:
    return [dict(X_plan=s.X_plan, U_plan=s.U_plan, lam=s.lam, u0=s.u0,
                 x1=s.x1) for s in samples]


def control_answers(samples: List[Sample], config: dict, device) -> List[dict]:
    """The control: the reference in the program's place, in float32 with
    TF32 on, the step below the configuration's float32 with TF32 off."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        ans = reference_answers(samples, config, torch.float32, device)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    return ans


def _q(v, q):
    if v.size == 0:
        return float("nan")
    v = np.where(np.isfinite(v), v, np.inf)
    return float(np.quantile(v, q, method="higher"))


def _rows(g, mask):
    """The kept scenario-steps where ``mask`` holds."""
    return {k: v[mask] for k, v in g.items() if k != "runaway_window"}


def _cold(g):
    return _rows(g, g["cold"] > 0)


def _steady(g):
    return _rows(g, g["cold"] == 0)


def _tame(g):
    return _rows(g, g["runaway"] == 0)


def _lam_rel(g):
    """The multipliers' gap relative to max(|lam_ref|, 1)."""
    return g["lam"] / np.maximum(g["lam_scale"], 1.0)


def _share(v):
    return float(v.mean()) if v.size else float("nan")


def _gain_deficit(g):
    """1 - (the answer's merit gain) / (the reference's), each summed over
    the scenario-steps and each the L1 merit's fall from the step's
    starting plan.  A solve that returns its warm start reads 1, one that
    gains what the reference gains reads 0; where rounding lets the
    program gain more than the float64 reference, it reads below 0."""
    ref = g["gain_ref"].sum()
    if g["gain_ref"].size == 0 or not ref > 0:
        return float("nan")
    gain = g["gain"].sum()
    return float(1.0 - gain / ref) if np.isfinite(gain) else float("inf")


# every number the check compares, by name: a statistic over the sampled
# scenario-steps of one gap (PERF.md gives the readings behind each limit)
NUMBERS = {
    # the window's first step, cold from the benchmark's own scenarios:
    # the multipliers' gap relative to max(|lam|, 1), 75th percentile
    "lam_cold_p75": lambda g: _q(_lam_rel(_cold(g)), 0.75),
    # the same step's plan: its merit's excess over the reference's, median
    "merit_cold_p50": lambda g: _q(_cold(g)["merit_excess"], 0.5),
    # every kept step: the next state against the reference's simulation
    # of the program's own applied control, worst element relative to
    # 1 + its size
    "x1_rel_max": lambda g: _q(g["x1"], 1.0),
    # the other kept steps (the steady controller: cyclic reduction, the
    # short ladder, the shifted warm start): the share of the reference's
    # merit gain, from the same starting plans, that the program lacks
    "steady_gain_deficit": lambda g: _gain_deficit(_steady(g)),
    # the same over the steady steps that do not run away
    "steady_gain_deficit_tame": lambda g: _gain_deficit(_tame(_steady(g))),
    # the tame steady steps' multipliers, as in lam_cold_p75: where the
    # solve starts from the warm start (PCG), a dropped warm start moves it
    "lam_steady_p75": lambda g: _q(_lam_rel(_tame(_steady(g))), 0.75),
    # the share of the window's scenario-steps that run away
    "runaway_share": lambda g: _share(g.get("runaway_window", np.empty(0))),
    # the share of kept scenario-steps with an output that is not finite
    "nonfinite_share": lambda g: _share(g["nonfinite"]),
}


def judge(g: Dict[str, np.ndarray], limits: dict) -> Dict[str, dict]:
    """Each number the cell's limits name, and each of ``REQUIRED``,
    beside its limit."""
    return {name: {"value": NUMBERS[name](g), "limit": lim}
            for name, lim in {**limits["numbers"], **REQUIRED}.items()}
