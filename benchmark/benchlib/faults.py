"""Faults planted under the timed path, to show that the check fails
them: each is a context manager that breaks the port where the fault
would live and restores it after.

* ``unchanged``: every SQP solve returns its warm start (plan and
  multipliers) unchanged;
* ``half``: every solve leaves the second half of its batch out: those
  scenarios get their warm start back, unsolved;
* ``steady_unchanged``, ``steady_half``: the same, in the steady steps
  alone (the solves that start from a carried plan); the cold first step
  of each episode solves as it should;
* ``altered``: the next state of the batch's first scenario is moved by
  0.01 where the control step hands it out;
* ``nonfinite_lam``: the multipliers of an eighth of the batch (at least
  one scenario) are NaN where the control step hands them out: too few
  for a 75th percentile to see.
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = ("unchanged", "half", "steady_unchanged", "steady_half", "altered",
          "nonfinite_lam")


@contextlib.contextmanager
def planted(name: str):
    from trajoptmpcreference_tpu_torch.solvers.mpc import MPCController
    from trajoptmpcreference_tpu_torch.solvers.sqp import SQPSolver
    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}")
    saved = []
    orig_run = MPCController.run
    if name == "altered":
        def run(self, *a, **k):
            res = orig_run(self, *a, **k)
            X = res.X_applied.clone()
            X[0, 0, -1] += 0.01
            return res._replace(X_applied=X)
    elif name == "nonfinite_lam":
        def run(self, *a, **k):
            res = orig_run(self, *a, **k)
            lam = res.lam_last.clone()
            lam[:max(1, lam.shape[0] // 8)] = float("nan")
            return res._replace(lam_last=lam)
    else:
        steady_only = name.startswith("steady_")
        kind = name.removeprefix("steady_")
        warm = []                       # whether the running step is warm

        def run(self, x0, steps, X_init=None, *a, **k):
            warm.append(X_init is not None)
            try:
                return orig_run(self, x0, steps, X_init, *a, **k)
            finally:
                warm.pop()
        orig = SQPSolver.solve

        def solve(self, x0, u0, cost_params=None, cstate=None, guess=None):
            res = orig(self, x0, u0, cost_params=cost_params, cstate=cstate,
                       guess=guess)
            if steady_only and not (warm and warm[-1]):
                return res
            lam = torch.zeros_like(res.lam) if guess is None else guess
            if kind == "unchanged":
                return res._replace(X=x0, U=u0, lam=lam)
            h = res.X.shape[0] // 2
            keep = lambda new, old: torch.cat([new[:h], old[h:]])
            return res._replace(X=keep(res.X, x0), U=keep(res.U, u0),
                                lam=keep(res.lam, lam))
        SQPSolver.solve = solve
        saved.append(lambda: setattr(SQPSolver, "solve", orig))
    MPCController.run = run
    saved.append(lambda: setattr(MPCController, "run", orig_run))
    try:
        yield
    finally:
        for undo in saved:
            undo()
