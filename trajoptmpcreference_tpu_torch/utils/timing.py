"""Wall-clock timing with a device-completion barrier.

Port of trajoptmpcreference_tpu/utils/timing.py.  PyTorch returns from a
CUDA call before the device finishes, so ``time_fn`` waits with
``torch.cuda.synchronize()`` whenever an output tensor lies on a CUDA
device; CPU results are complete when the call returns.
"""

from __future__ import annotations

import time
from typing import Callable, Tuple

import torch


def _tensors(tree):
    """The tensors in a nest of tuples, lists, dicts and NamedTuples."""
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


def _sync(tree):
    devices = {t.device for t in _tensors(tree) if t.device.type == "cuda"}
    for d in devices:
        torch.cuda.synchronize(d)


def time_fn(fn: Callable, *args, reps: int = 3,
            warmup: int = 1) -> Tuple[float, object]:
    """Return (best wall seconds over ``reps`` calls, last result), after
    ``warmup`` calls that build caches and libraries."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
        _sync(out)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        _sync(out)
        best = min(best, time.perf_counter() - t0)
    return best, out
