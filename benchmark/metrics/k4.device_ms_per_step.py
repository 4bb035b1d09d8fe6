"""Device milliseconds per control step of K4, the fused PCG
(kernels/csrc/pcg.cu: its kernels, matched by name), over the traced
stretch."""

from benchlib import k4_count


def read(run):
    s = run.stretch
    secs = [o.seconds for o in s.ops if k4_count.is_k4(o.name)]
    return 1e3 * sum(secs) / s.steps if secs else None
