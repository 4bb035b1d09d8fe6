"""Share of a control step in which no device operation runs: 1 - (the
union of the device operations' intervals in the traced stretch, per
step) / (the mean step time outside the stretch, on the host clock).  The
profiler slows the stretch's host side, so its own wall would overstate
the idle share."""

from benchlib import stats


def read(run):
    s = run.stretch
    return stats.idle_pct(s.busy_s / s.steps, run.step_s) if s.ops else None
