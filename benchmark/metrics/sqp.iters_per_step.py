"""Mean SQP iterations per scenario-step over the window, from the
port's own count (MPCResult.iters)."""


def read(run):
    return run.iters
