"""Two timings of one call on the card.

``events_ms``: a CUDA-event pair around the call.  It measures the larger
of the device's time and the host's time to enqueue the call: a kernel of
tens of microseconds behind a Python wrapper measures the wrapper.  It is
the yardstick the kernels' ``ms`` has used since their first port.

``device_ms``: the same events, behind a spin (``torch.cuda._sleep``) on
the stream long enough to outlast the host's enqueue, so the events and
the call's kernels run back to back on the device: the device's time
alone.  A call that synchronises with the host inside (a loop that reads a
device flag) still measures host and device together.

Compare two versions only with the same one of the two.
"""

from __future__ import annotations

import statistics
import time

import torch

# cycles of the device spin per second of host enqueue time, above the
# H100's 1.98 GHz boost clock
_CYCLES_PER_S = 2.0e9


def events_ms(fn, reps: int = 20) -> float:
    """Median of ``reps`` single-call times from CUDA events (ms)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, reps: int = 20) -> float:
    """Median of ``reps`` device times of ``fn()`` (ms), CUDA events."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin = int(2.0 * host_s * _CYCLES_PER_S) + 200_000
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)
