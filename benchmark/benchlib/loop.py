"""The timed path: the port's closed loop, one control step at a time.

Each control step is one call of ``MPCController.run(x, 1, ...)``, the
warm start (plan, multipliers, soft state) carried from the last call
through its ``X_init`` / ``U_init`` / ``cstate_init`` / ``lam_init``
hooks as ``run_scheduled`` carries it.  An episode is
``episode_steps`` steps: the first ``cold_steps`` on the cold controller,
the rest on the steady one; episodes run back to back.  A step's time
runs on the host clock from its call to its applied control on the host.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from benchlib import traffic as T


@dataclasses.dataclass
class Sample:
    """One step kept for the check: what went in and what came out."""

    episode: int
    step: int
    cold: bool
    rows: torch.Tensor                    # the scenarios checked
    x: torch.Tensor                       # (b, nx) the state at the step
    goals: torch.Tensor                   # (b, 6)
    X_init: Optional[torch.Tensor]        # (b, nx, N) the warm start
    U_init: Optional[torch.Tensor]
    lam_init: Optional[torch.Tensor]
    cstate_init: Optional[tuple]
    X_plan: torch.Tensor                  # the returned, shifted plan
    U_plan: torch.Tensor
    lam: torch.Tensor
    u0: torch.Tensor                      # the applied control
    x1: torch.Tensor                      # the next state


def build(config: dict, device):
    """(plant, cost, steady controller, cold controller) from the knobs
    the configuration states, every one passed explicitly."""
    from trajoptmpcreference_tpu_torch import flagship as F
    dtype = getattr(torch, config["dtype"])
    out = []
    for name in ("knobs", "cold_knobs"):
        kn = dict(config[name])
        out.append(F.flagship_mpc(sim_qd_max=kn.pop("sim_qd_max"),
                                  dtype=dtype, device=device, **kn))
    (plant, cost, ctrl), (_, _, cold) = out
    return plant, cost, ctrl, cold


class ClosedLoop:
    """Episodes of the cell's traffic on the port, step by step."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.dtype = getattr(torch, config["dtype"])
        self.plant, self.cost, self.ctrl, self.cold = build(config, device)
        self.B = traffic["batch"]
        self.steps_per_episode = traffic["episode_steps"]
        self.cold_steps = config["cold_steps"]
        self.episode = -1
        self.new_episode(0)

    def new_episode(self, e: int):
        x0s, goals = T.episode(self.traffic, self.seed, e)
        t = lambda a: torch.as_tensor(a, dtype=self.dtype, device=self.device)
        self.episode, self.k = e, 0
        self.x0, self.goals = t(x0s), t(goals)
        self.x = self.x0
        self.params = self.cost.default_params._replace(xg=self.goals)
        self.carry = {}

    def step(self):
        """One control step; returns (result, inputs) once the applied
        control is on the host."""
        ctrl = self.cold if self.k < self.cold_steps else self.ctrl
        inputs = dict(x=self.x, **self.carry)
        res = ctrl.run(self.x, 1, cost_params=self.params, **self.carry)
        res.U_applied[..., 0].cpu()             # waits for the device
        self.carry = dict(X_init=res.X_plan_last, U_init=res.U_plan_last,
                          cstate_init=res.cstate_last, lam_init=res.lam_last)
        self.x = res.X_applied[..., -1]
        self.k += 1
        return res, inputs

    @property
    def episode_done(self) -> bool:
        return self.k >= self.steps_per_episode


class Window:
    """Runs steps until ``seconds`` have passed, episode after episode, and
    records what the metrics and the check need."""

    def __init__(self, loop: ClosedLoop, seconds: float, rng: np.random.Generator,
                 check: dict, trace_at: Optional[int] = None,
                 trace_steps: int = 0):
        self.loop, self.seconds, self.rng = loop, seconds, rng
        self.check = check
        self.trace_at, self.trace_steps = trace_at, trace_steps
        self.step_s: List[float] = []
        self.iters: List[torch.Tensor] = []
        self.bad: List[torch.Tensor] = []
        self.finals: List[tuple] = []         # (x0, goals, x_final) per episode
        self.reservoir: List[tuple] = []
        self.profile = None
        self.window_s = 0.0

    def _keep(self, g: int, res, inputs, loop: ClosedLoop):
        """Keep the episode's first cold step, and a uniform sample of
        ``check['steps']`` of all the window's steps (reservoir sampling,
        drawn from the seed)."""
        entry = (loop.episode, loop.k - 1, loop.k - 1 < loop.cold_steps,
                 loop.goals, inputs, res)
        if g == 0:
            self.first = entry
            return
        K = self.check["steps"]
        if len(self.reservoir) < K:
            self.reservoir.append(entry)
        else:
            j = int(self.rng.integers(0, g))
            if j < K:
                self.reservoir[j] = entry

    def run(self):
        from benchlib import trace as TR
        loop = self.loop
        prof = None
        t_start = time.perf_counter()
        g = 0
        while True:
            if loop.episode_done:
                self.finals.append((loop.x0, loop.goals, loop.x))
                loop.new_episode(loop.episode + 1)
            tracing = (self.trace_at is not None
                       and self.trace_at <= g < self.trace_at + self.trace_steps)
            if tracing and prof is None:
                prof, spans = _start_profile()
            t0 = time.perf_counter()
            with (torch.profiler.record_function(TR.STEP_SPAN) if tracing
                  else contextlib.nullcontext()):
                res, inputs = loop.step()
            self.step_s.append(time.perf_counter() - t0)
            if prof is not None and not tracing:
                self.profile = _stop_profile(prof, spans)
                prof = None
            self.iters.append(res.iters[..., 0])
            self.bad.append(~(torch.isfinite(res.X_plan_last).flatten(1).all(1)
                              & torch.isfinite(res.U_plan_last).flatten(1).all(1)))
            self._keep(g, res, inputs, loop)
            g += 1
            self.window_s = time.perf_counter() - t_start
            if self.window_s >= self.seconds and prof is None:
                break
        if loop.episode_done:
            self.finals.append((loop.x0, loop.goals, loop.x))
        self.steps = g

    def samples_for_check(self) -> List[Sample]:
        """The kept steps, each cut to a sample of its scenarios drawn
        from the seed: ``cold_scenarios`` of the window's first step,
        ``scenarios_per_step`` of each other kept step."""
        out = []
        for n, (ep, k, cold, goals, inputs, res) in enumerate(
                [self.first] + self.reservoir):
            B = goals.shape[0]
            per = self.check["cold_scenarios" if n == 0
                             else "scenarios_per_step"]
            rows = torch.as_tensor(np.sort(self.rng.choice(B, min(per, B),
                                                           replace=False)),
                                   device=goals.device)
            pick = lambda t: None if t is None else t[rows]
            out.append(Sample(
                ep, k, cold, rows, pick(inputs["x"]), pick(goals),
                pick(inputs.get("X_init")), pick(inputs.get("U_init")),
                pick(inputs.get("lam_init")),
                None if "cstate_init" not in inputs else tuple(
                    type(st)(*(a[rows] for a in st))
                    for st in inputs["cstate_init"]),
                pick(res.X_plan_last), pick(res.U_plan_last),
                pick(res.lam_last), pick(res.U_applied[..., 0]),
                pick(res.X_applied[..., -1])))
        return out


def _start_profile():
    from benchlib import trace as TR
    spans = TR.spans()
    spans.__enter__()
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
    prof.__enter__()
    return prof, spans


def _stop_profile(prof, spans):
    prof.__exit__(None, None, None)
    spans.__exit__(None, None, None)
    return prof


def replay(loop: ClosedLoop, samples: List[Sample]) -> List[dict]:
    """The program's own step again from each sample's inputs, on the
    sampled scenarios alone (for a planted fault's readings)."""
    out = []
    for s in samples:
        ctrl = loop.cold if s.cold else loop.ctrl
        params = loop.cost.default_params._replace(xg=s.goals)
        kw = {} if s.X_init is None else dict(
            X_init=s.X_init, U_init=s.U_init, lam_init=s.lam_init,
            cstate_init=s.cstate_init)
        res = ctrl.run(s.x, 1, cost_params=params, **kw)
        out.append(dict(X_plan=res.X_plan_last, U_plan=res.U_plan_last,
                        lam=res.lam_last, u0=res.U_applied[..., 0],
                        x1=res.X_applied[..., -1]))
    return out
