"""Device milliseconds per control step of the operations launched
inside the linsolve layer's span (hand kernels included), over the
traced stretch."""

LAYER = "linsolve"


def read(run):
    s = run.stretch
    secs = [o.seconds for o in s.ops if o.layer == LAYER]
    return 1e3 * sum(secs) / s.steps if secs else None
