"""Device milliseconds per control step of the lanes kernels K1-K3
(fd_grad, fd, task_vec) over the traced stretch."""


def read(run):
    s = run.stretch
    launches = s.lanes_launches()
    return 1e3 * sum(t for _, _, t in launches) / s.steps if launches else None
