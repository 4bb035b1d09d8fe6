"""K1-K3 pooled: the sum over their launches of each launch's bound,
max(lanes x needed ops / peak FLOP/s, lanes x bytes / peak bytes/s), over
the sum of their device times, in percent.  The per-lane counts are the
configuration's frozen ones, the peaks benchmark/peaks.json's."""

from benchlib import stats


def read(run):
    launches = run.stretch.lanes_launches()
    if not launches:
        return None
    return stats.roofline_pct(launches, run.cell.config["kernels"], run.peaks)
