"""Device operations (kernels, copies, sets) per control step over the
traced stretch: the work the host dispatches one by one."""


def read(run):
    s = run.stretch
    return len(s.ops) / s.steps if s.ops else None
