"""Operation accounting of one eager call.

Port of trajoptmpcreference_tpu/utils/flops.py.  The JAX function reads
XLA's compile-time cost analysis of the fused program; an eager PyTorch
call has no such program, so ``cost_analysis`` runs the function instead:
once under ``torch.utils.flop_counter.FlopCounterMode`` for the floating
point operations of its matrix products (elementwise arithmetic is not
counted), and, when the call puts work on a CUDA device, once more under
``torch.profiler`` for what reached the device.  XLA's "bytes accessed"
has no counterpart here and is not reported.
"""

from __future__ import annotations

import time
from typing import Any, Dict

import torch

from trajoptmpcreference_tpu_torch.utils.timing import _tensors


def cost_analysis(fn, *args, **kwargs) -> Dict[str, Any]:
    """Keys: ``flops`` (FlopCounterMode's count of one call), and when an
    argument or an output lies on a CUDA device, of one more call after
    that one:
    ``device_ops`` (the kernels, copies and sets it put on the device, from
    torch.profiler's CUDA activity), ``device_ms`` (their summed device
    time), ``host_ms`` (the host clock around the profiled call, the
    profiler's overhead included) and ``peak_bytes`` (the device memory
    allocated at most during it).  The first call also warms the caches
    the second reads."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        out = fn(*args, **kwargs)
    stats: Dict[str, Any] = {"flops": counter.get_total_flops()}
    devices = {t.device for t in _tensors((args, kwargs, out))
               if t.device.type == "cuda"}
    del out                      # the profiled call starts from the same memory
    if not devices:
        return stats
    from torch.profiler import ProfilerActivity, profile

    for d in devices:
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        for d in devices:
            torch.cuda.synchronize(d)
        host = time.perf_counter() - t0
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    stats.update(device_ops=len(events),
                 device_ms=1e-3 * sum(e.device_time_total for e in events),
                 host_ms=1e3 * host,
                 peak_bytes=max(torch.cuda.max_memory_allocated(d)
                                for d in devices))
    return stats
