"""The traced stretch: spans around the port's layers, the profiler's
device trace, and what the per-layer readers take from them.

The port has no spans of its own yet, so in a traced run the harness
wraps five of its calls by name with ``torch.profiler.record_function``
(and every control step with ``mpc.step``): ``SQPSolver.solve``,
``KKTSystem.form_blocks``, ``KKTSystem.solve_schur``,
``SQPSolver.line_search`` and ``ops.lanes.launch``, whose span also names
the library, the joint count and the lanes of the launch.  A device
operation belongs to the innermost span whose host interval holds the
runtime call that launched it (linked by the trace's correlation ids).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
from typing import List, Optional, Tuple

from benchlib import stats

LAYER_SPANS = {"KKTSystem.form_blocks": "kkt",
               "KKTSystem.solve_schur": "linsolve",
               "SQPSolver.line_search": "linesearch"}
LANES_SPAN = "lanes.launch"
STEP_SPAN = "mpc.step"
KERNEL_NAMES = {"fd_grad": "fd_grad_kernel", "fd": "fd_kernel",
                "task_vec": "task_vec_kernel"}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def spans():
    """Wrap the port's layer entry points in named spans while the block
    runs; restore them after."""
    import torch
    from trajoptmpcreference_tpu_torch.ops import kinematics, lanes
    from trajoptmpcreference_tpu_torch.solvers.kkt import KKTSystem
    from trajoptmpcreference_tpu_torch.solvers.sqp import SQPSolver

    rf = torch.profiler.record_function
    saved = []

    def wrap(owner, attr, label):
        orig = getattr(owner, attr)
        saved.append((owner, attr, orig))

        def wrapped(*a, **k):
            with rf(label):
                return orig(*a, **k)
        setattr(owner, attr, wrapped)

    wrap(SQPSolver, "solve", "SQPSolver.solve")
    wrap(KKTSystem, "form_blocks", "KKTSystem.form_blocks")
    wrap(KKTSystem, "solve_schur", "KKTSystem.solve_schur")
    wrap(SQPSolver, "line_search", "SQPSolver.line_search")
    launch = lanes.launch

    def recording(lib_name, n, packed, out, q, qd, u=None):
        with rf(f"{LANES_SPAN}/{lib_name}/{n}/{q.shape[1]}"):
            return launch(lib_name, n, packed, out, q, qd, u)
    for mod in (lanes, kinematics):
        saved.append((mod, "launch", getattr(mod, "launch")))
        mod.launch = recording
    try:
        yield
    finally:
        for owner, attr, orig in reversed(saved):
            setattr(owner, attr, orig)


@dataclasses.dataclass
class DeviceOp:
    name: str
    start: float          # seconds on the trace's clock
    end: float
    spans: Tuple[str, ...]   # enclosing harness spans, outermost first

    @property
    def seconds(self) -> float:
        return self.end - self.start

    @property
    def layer(self) -> Optional[str]:
        for s in reversed(self.spans):
            if s in LAYER_SPANS:
                return LAYER_SPANS[s]
        return None

    @property
    def launch(self) -> Optional[Tuple[str, int, int]]:
        """(library, joints, lanes) of a lanes-kernel launch."""
        if self.spans and self.spans[-1].startswith(LANES_SPAN + "/"):
            _, lib, n, L = self.spans[-1].split("/")
            return lib, int(n), int(L)
        return None


@dataclasses.dataclass
class Stretch:
    """The traced steps: their device operations and host spans."""

    ops: List[DeviceOp]
    host_spans: List[Tuple[str, float, float]]
    steps: int
    start: float
    end: float
    kernel_link: str      # how K1-K3 launches were tied to their lanes

    @property
    def window_s(self) -> float:
        return self.end - self.start

    @property
    def busy_s(self) -> float:
        return stats.union_length(((o.start, o.end) for o in self.ops),
                                  self.start, self.end)

    def lanes_launches(self) -> List[Tuple[str, int, float]]:
        """(library, lanes, device seconds) of every K1-K3 launch."""
        return [(o.launch[0], o.launch[2], o.seconds) for o in self.ops
                if o.launch is not None]

    def innermost_at(self, t: float) -> str:
        best = None
        for name, s, e in self.host_spans:
            if s <= t < e and (best is None or s >= best[1]):
                best = (name, s, e)
        return best[0].split("/")[0] if best else "outside spans"

    def breakdown(self, top: int = 10) -> dict:
        by_name = collections.Counter()
        for o in self.ops:
            by_name[o.name[:120]] += o.seconds
        busy = stats.merged(((o.start, o.end) for o in self.ops),
                            self.start, self.end)
        edges = [self.start] + [t for iv in busy for t in iv] + [self.end]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
        return {"device_ops": [[n, s] for n, s in by_name.most_common(top)],
                "idle_gaps": [[self.innermost_at(0.5 * (s + e)), e - s]
                              for s, e in gaps[:top]]}


def parse_chrome_trace(events: List[dict], steps: int) -> Stretch:
    """The stretch from a profiler's chrome-trace events (times in us)."""
    host = [(e["name"], e["ts"] * 1e-6, (e["ts"] + e.get("dur", 0)) * 1e-6)
            for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    step_spans = [(s, e) for n, s, e in host if n == STEP_SPAN]
    start = min(s for s, _ in step_spans)
    end = max(e for _, e in step_spans)
    launch_ts = {e["args"]["correlation"]: e["ts"] * 1e-6 for e in events
                 if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime",
                                                            "cuda_driver")
                 and "correlation" in e.get("args", {})}
    ordered = sorted(host, key=lambda h: (h[1], -h[2]))
    dev = [e for e in events
           if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    when = [launch_ts.get(e.get("args", {}).get("correlation")) for e in dev]
    enclosing = _enclosing(ordered, when)
    ops = [DeviceOp(e["name"], e["ts"] * 1e-6,
                    (e["ts"] + e.get("dur", 0)) * 1e-6, enc)
           for e, enc in zip(dev, enclosing)]
    ops = [o for o in ops if o.end > start and o.start < end]
    ops.sort(key=lambda o: o.start)
    link = _link_lanes_kernels(ops, ordered)
    return Stretch(ops, host, steps, start, end, link)


def _enclosing(ordered, times):
    """For each time (or None), the spans of ``ordered`` (sorted by start,
    the longer first) that hold it, outermost first: one sweep."""
    out = [()] * len(times)
    idx = sorted((t, i) for i, t in enumerate(times) if t is not None)
    active, j = [], 0
    for t, i in idx:
        while j < len(ordered) and ordered[j][1] <= t:
            active.append(ordered[j])
            j += 1
        active = [a for a in active if a[2] > t]
        out[i] = tuple(a[0] for a in active)
    return out


def _link_lanes_kernels(ops: List[DeviceOp], host) -> str:
    """Tie each K1-K3 kernel to its ``lanes.launch`` span.  By correlation
    where the trace links the ctypes launch to its kernel; where it does
    not, by kernel name, the i-th kernel of a library to the i-th launch
    span of that library.  Returns which way was used."""
    kernels = {lib: [o for o in ops if o.name.split("<")[0].split("(")[0]
                     .split()[-1] == kname]
               for lib, kname in KERNEL_NAMES.items()}
    if all(o.launch is not None for ks in kernels.values() for o in ks):
        return "correlation"
    for lib, ks in kernels.items():
        launches = [n for n, _, _ in host
                    if n.startswith(f"{LANES_SPAN}/{lib}/")]
        for o, span in zip(ks, launches):
            if o.launch is None:
                o.spans = o.spans + (span,)
    return "kernel name"


def load_trace(path: str) -> List[dict]:
    with open(path) as f:
        return json.load(f)["traceEvents"]
