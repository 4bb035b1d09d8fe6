"""The benchmark's arithmetic: rates, percentiles, interval unions and the
roofline of the lanes kernels.  Pure functions of numbers, so the tests
check them on synthetic data."""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import numpy as np


def solves_per_s(batch: int, steps: int, window_s: float) -> float:
    """Scenario-solves completed per second of the window."""
    return batch * steps / window_s


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile of every value, linear between order
    statistics."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def union_length(intervals: Iterable[Tuple[float, float]],
                 lo: float = -np.inf, hi: float = np.inf) -> float:
    """Length of the union of [start, end) intervals clipped to [lo, hi]."""
    return sum(e - s for s, e in merged(intervals, lo, hi))


def merged(intervals: Iterable[Tuple[float, float]], lo: float = -np.inf,
           hi: float = np.inf) -> List[Tuple[float, float]]:
    """The union of the intervals clipped to [lo, hi], as sorted disjoint
    intervals."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def idle_pct(busy_s: float, window_s: float) -> float:
    return 100.0 * (1.0 - busy_s / window_s)


def launch_bound_s(lanes: int, ops_per_lane: float, bytes_per_lane: float,
                   peak_flops: float, peak_bytes: float) -> float:
    """The least time one launch over ``lanes`` lanes can take: its
    operations at the compute peak or its bytes at the memory peak,
    whichever is longer."""
    return max(lanes * ops_per_lane / peak_flops,
               lanes * bytes_per_lane / peak_bytes)


def roofline_pct(launches: Iterable[Tuple[str, int, float]], counts: dict,
                 peaks: dict) -> float:
    """Sum of the launches' bounds over the sum of their device times, in
    percent.  ``launches``: (library, lanes, device seconds); ``counts``:
    per library ``ops_per_lane`` and ``bytes_per_lane``."""
    bound = spent = 0.0
    for lib, lanes, secs in launches:
        c = counts[lib]
        bound += launch_bound_s(lanes, c["ops_per_lane"], c["bytes_per_lane"],
                                peaks["f32_flops"], peaks["hbm_bytes_per_s"])
        spent += secs
    return 100.0 * bound / spent
