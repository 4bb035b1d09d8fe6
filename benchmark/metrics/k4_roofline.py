"""K4's share of its bound: the sum over the traced K4 launches (kernels
matched by name) of each launch's bound, over the sum of their device
times, in percent.  A launch's bound is max(needed operations / peak
FLOP/s, bytes / peak bytes/s) for the cell's B scenarios, horizon N and
Schur block size bs = nx at the process's mean iterations per scenario per
call (``pcg.iters_per_call``), each counted as leaving on its threshold
(``benchlib/k4_count.py``); the peaks are benchmark/peaks.json's."""

from benchlib import k4_count


def read(run):
    secs = [o.seconds for o in run.stretch.ops if k4_count.is_k4(o.name)]
    iters = k4_count.iters_per_call()
    if not secs or iters is None:
        return None
    cfg = run.cell.config
    bound = k4_count.bound_s(run.cell.traffic["batch"], int(cfg["horizon"]),
                             2 * int(cfg["robot"]["links"]), iters,
                             k4_count.itemsize(cfg), run.peaks)
    return 100.0 * bound * len(secs) / sum(secs)
