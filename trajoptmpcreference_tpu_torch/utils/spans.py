"""The port's own tracing: host-time spans, host reads of device flags,
and kernel launch counts, kept in memory until a caller takes a
``snapshot()``.

* ``span(name)``: while tracing is off (the default) it returns one shared
  no-op context and reads no clock.  While it is on, it adds the span's
  calls, inclusive nanoseconds and self nanoseconds (inclusive minus its
  child spans) under ``name``, on ``time.perf_counter_ns``; while a
  ``torch.profiler`` is active it also opens
  ``torch.profiler.record_function(name)``, so the span lands in the
  profiler's trace on the clock of the device operations it launched.
* ``host_bool(t, site)``: ``bool(t)`` for a device flag, the one way the
  port waits on the device for a decision.  Every read is counted under
  ``sync/<site>``; while tracing is on the wait is also timed as the child
  span ``sync/<site>``, so it leaves the self time of the span around it.
* ``launched(kernel)``: counts one launch of a hand kernel under
  ``launch/<kernel>``, always.
* ``graphed(site)``: counts one capture or replay of a CUDA graph under
  ``graph/<site>``, always; while tracing is on it also times the call as
  the child span ``graph/<site>``.
* ``tally(key, value)``: adds to the total ``key``, always: a number on
  the host, a tensor's sum on its own device, so that a count the device
  holds (K4's iterations) costs no host read in the step; ``snapshot()``
  reads the device totals, one host read each.  The totals kept:
  ``pcg/iters``, the iterations that K4 or its plain version returned,
  summed over scenarios and calls, and ``pcg/scenarios``, the scenarios
  those calls solved (``ops/fused_pcg.make_batched_pcg``).

``enable(True)`` switches tracing on; ``reset()`` clears every total and
count.  The spans are named after the layer call they time (the layers of
PERF.md section 3):

    MPCController.run           one control step (args: the step's index)
      MPCController.simulate    the simulated plant and its clamp
      SQPSolver.solve
        SQPSolver.sqp_iterate
          KKTSystem.form_blocks
          KKTSystem.solve_schur
            KKTSystem.schur_blocks   the split, condensed or generic assembly
            btridiag.solve           cyclic reduction, Thomas or PCG
              fused_pcg.launch       K4 (its plain version on CPU tensors)
            KKTSystem.recover_dxu
            graph/solve_schur.capture  the exact solve captured (CUDA)
            graph/solve_schur.replay   the exact solve replayed (CUDA)
          SQPSolver.line_search
        sync/<site>             inside host_bool

On CUDA tensors the exact Schur solve runs as one CUDA graph per shape
(``KKTSystem.solve_schur``): a replayed call enters
``graph/solve_schur.replay`` and none of ``KKTSystem.schur_blocks``,
``btridiag.solve`` and ``KKTSystem.recover_dxu``, whose work the graph
holds; those three are entered by eager calls and by a capture.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Dict, List, Optional, Tuple

import torch

_on = False
_totals: Dict[str, List[int]] = {}       # name -> [calls, ns, self ns]
_syncs: Dict[str, int] = {}              # site -> host reads
_launches: Dict[str, int] = {}           # kernel -> launches
_graphs: Dict[str, int] = {}             # site -> graph captures, replays
_tallies: Dict[str, int] = {}            # key -> total kept on the host
_device_tallies: Dict[Tuple[str, torch.device], torch.Tensor] = {}
_stack: List["_Span"] = []
_step = 0                                # control steps traced so far
_clock = time.perf_counter_ns
_profiling = torch.autograd._profiler_enabled
OFF = contextlib.nullcontext()           # what ``span`` returns while off


class _Span:
    __slots__ = ("name", "args", "rf", "t0", "child")

    def __init__(self, name: str, args: Optional[str] = None):
        self.name, self.args = name, args

    def __enter__(self):
        self.rf = None
        if _profiling():
            self.rf = torch.profiler.record_function(self.name, self.args)
            self.rf.__enter__()
        self.child = 0
        _stack.append(self)
        self.t0 = _clock()
        return self

    def __exit__(self, *exc):
        ns = _clock() - self.t0
        _stack.pop()
        if _stack:
            _stack[-1].child += ns
        tot = _totals.get(self.name)
        if tot is None:
            tot = _totals[self.name] = [0, 0, 0]
        tot[0] += 1
        tot[1] += ns
        tot[2] += ns - self.child
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def enable(on: bool = True) -> None:
    """Switch tracing on or off.  Counts are kept either way."""
    global _on
    _on = bool(on)


def span(name: str):
    """A context that times its block under ``name`` while tracing is on;
    the shared no-op ``OFF`` while it is off."""
    if not _on:
        return OFF
    return _Span(name)


def traced(name: str):
    """Decorator: the call runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def step_span():
    """The span of one control step, ``MPCController.run``, carrying the
    step's index (counted from the last ``reset``) as its profiler args,
    so every span of one control step shares an identifier."""
    global _step
    if not _on:
        return OFF
    _step += 1
    return _Span("MPCController.run", str(_step - 1))


def host_bool(t: torch.Tensor, site: str) -> bool:
    """``bool(t)``, counted under ``sync/<site>``; timed as the span
    ``sync/<site>`` while tracing is on."""
    _syncs[site] = _syncs.get(site, 0) + 1
    if not _on:
        return bool(t)
    with _Span("sync/" + site):
        return bool(t)


def launched(kernel: str) -> None:
    """Count one launch of hand kernel ``kernel`` (fd, fd_grad, task_vec,
    pcg) under ``launch/<kernel>``."""
    _launches[kernel] = _launches.get(kernel, 0) + 1


def graphed(site: str):
    """Count one call under ``graph/<site>`` (``solve_schur.capture``,
    ``solve_schur.replay``); returns the span ``graph/<site>`` that times
    it while tracing is on, the shared no-op ``OFF`` while it is off."""
    _graphs[site] = _graphs.get(site, 0) + 1
    if not _on:
        return OFF
    return _Span("graph/" + site)


def tally(key: str, value) -> None:
    """Add ``value`` to the total ``key`` (``pcg/iters``, ...): an int on
    the host; an integer tensor summed on its own device into a running
    int64 total kept there (two device operations, no host read)."""
    if not isinstance(value, torch.Tensor):
        _tallies[key] = _tallies.get(key, 0) + value
        return
    acc = _device_tallies.get((key, value.device))
    if acc is None:
        acc = _device_tallies[(key, value.device)] = torch.zeros(
            (), dtype=torch.int64, device=value.device)
    acc.add_(value.sum())


def _tally_totals() -> Dict[str, int]:
    """Every total of ``tally``, the device ones read to the host."""
    out = dict(_tallies)
    for (key, _), acc in _device_tallies.items():
        out[key] = out.get(key, 0) + acc.item()
    return out


def count(key: str) -> int:
    """The count under ``key`` (``launch/fd``, ``sync/sqp.round``,
    ``graph/solve_schur.replay``, ``pcg/iters``, ...)."""
    kind, _, name = key.partition("/")
    counts = {"launch": _launches, "sync": _syncs, "graph": _graphs}
    if kind in counts:
        return counts[kind].get(name, 0)
    return _tally_totals().get(key, 0)


def launch_counts() -> Dict[str, int]:
    """``launch/<kernel>`` -> launches, as ``snapshot`` gives them, with no
    device read."""
    return {f"launch/{k}": n for k, n in _launches.items()}


def reset() -> None:
    """Clear every span total and every count (launches, graph calls and
    tallies included)."""
    global _step
    _totals.clear()
    _syncs.clear()
    _launches.clear()
    _graphs.clear()
    _tallies.clear()
    _device_tallies.clear()
    _step = 0


def snapshot() -> dict:
    """A copy of what has been recorded since the last ``reset``:
    ``{"spans": {name: {"calls", "ns", "self_ns"}}, "counts": {key: n}}``,
    the tallies among the counts (their device totals read here)."""
    return {"spans": {name: {"calls": c, "ns": ns, "self_ns": own}
                      for name, (c, ns, own) in _totals.items()},
            "counts": {**{f"sync/{k}": n for k, n in _syncs.items()},
                       **launch_counts(),
                       **{f"graph/{k}": n for k, n in _graphs.items()},
                       **_tally_totals()}}
