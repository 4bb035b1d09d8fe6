"""PCG iterations per scenario per call of K4 (or of its plain version):
the port's always-on totals ``pcg/iters`` over ``pcg/scenarios``
(``utils.spans``), summed on the device over every K4 call of the process,
warm-up included, and read once here.  A program without those totals
reports nothing."""

from benchlib import k4_count


def read(run):
    return k4_count.iters_per_call()
