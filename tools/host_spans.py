"""Where the host's time goes in a control step, from the port's own spans
and host-read counts (``utils.spans``), in cells of the benchmark.

    python tools/host_spans.py [--cells arm6_s.b1 arm6_s.b512 ...] [--seed N]

On the card, first the off path's cost on the host (``off_path_ns``:
nanoseconds per call of ``span``, ``traced`` and ``host_bool`` with
tracing off and on).  Then for each cell: the benchmark's closed loop
(``benchmark/``'s ``ClosedLoop``, built and warmed up as
``benchmark/run.py`` does), ``--pairs`` pairs of steady steps, the first
of each untraced and the second host-timed (the port's tracing on, no
profiler), then two profiled stretches of the traffic's trace steps: the
harness's own (its name-wrapped spans, the port's tracing off) and the
same with the port's spans on.  Writes one JSON line per cell to ``--out``
and a summary to standard output:

* ``host``: ``per_step`` of the host-timed steps' snapshot: host
  milliseconds per step by layer, host reads per step by site, the exact
  Schur solve's graph captures and replays per step and the share of its
  calls replayed, K4's calls per step (``fused_pcg.launch``) and its
  iterations per scenario per call (the device totals ``pcg/iters`` over
  ``pcg/scenarios``, on the PCG route alone), and the share of
  ``MPCController.run`` that the spans' self times account for.  A replayed ``KKTSystem.solve_schur`` enters
  ``graph/solve_schur.replay`` and not its three parts (assembly, solve,
  recovery): their times and calls count the eager calls and captures
  alone;
* ``on_cost_pct``: the host-timed steps' mean time over the untraced
  steps' mean, less one (``on_cost_median_pct``: the median of the pairs'
  ratios, less one);
* ``profiled``: for each profiled stretch, the device idle share against
  the untraced mean step (the benchmark's ``device.idle_pct``), the device
  milliseconds per step by layer, and the ten longest idle gaps, each put
  down to the innermost span at its midpoint, with the spans around it;
  for the stretch with the port's spans, the idle milliseconds per step
  under each innermost span.  Each garbage collection in a profiled
  stretch is a span of its own, ``gc/gen<n>``, and ``gc_ms_per_step``
  sums the collections' pauses (the set-up's objects are frozen first, as
  ``benchmark/run.py`` freezes them).

``--device cpu --batch 2`` rehearses the script on the CPU (no device
operations, so no idle share).
"""

from __future__ import annotations

import argparse
import bisect
import collections
import gc
import json
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
LAYERS = {"kkt": "KKTSystem.form_blocks", "linsolve": "KKTSystem.solve_schur",
          "linesearch": "SQPSolver.line_search"}
LINSOLVE_PARTS = ("KKTSystem.schur_blocks", "btridiag.solve",
                  "KKTSystem.recover_dxu")
K4_SPAN = "fused_pcg.launch"        # inside btridiag.solve, PCG route
CELLS = ("arm6_s.b1", "arm6_s.b512", "arm6_as.b512", "arm6_s.b4096",
         "arm6_pcg.b512")


def per_step(snap: dict):
    """Per-control-step host numbers of a ``spans.snapshot()`` taken over
    whole control steps, in milliseconds (None without a step span)."""
    sp = snap["spans"]
    steps = sp.get("MPCController.run", {}).get("calls", 0)
    if not steps:
        return None

    def ms(name, key="ns"):
        return sp.get(name, {}).get(key, 0) / 1e6 / steps

    # the host reads of these steps: one sync/<site> span each; the
    # graph captures and replays likewise
    syncs = {n: s["calls"] / steps for n, s in sp.items()
             if n.startswith("sync/")}
    graphs = {n: s["calls"] / steps for n, s in sp.items()
              if n.startswith("graph/")}
    solves = sp.get(LAYERS["linsolve"], {}).get("calls", 0)
    counts = snap.get("counts", {})
    pcg_scenarios = counts.get("pcg/scenarios", 0)
    return {
        "steps": steps,
        "step_ms": ms("MPCController.run"),
        "host.syncs_per_step": sum(syncs.values()),
        "host.sync_wait_ms_per_step": sum(ms(n) for n in sp
                                          if n.startswith("sync/")),
        **{f"{layer}.host_ms_per_step": ms(name)
           for layer, name in LAYERS.items()},
        "sqp.host_self_ms_per_step": (ms("SQPSolver.solve", "self_ns")
                                      + ms("SQPSolver.sqp_iterate", "self_ns")),
        "mpc.host_self_ms_per_step": (ms("MPCController.run", "self_ns")
                                      + ms("MPCController.simulate", "self_ns")),
        "linsolve_parts_ms": {n: ms(n) for n in LINSOLVE_PARTS},
        "linsolve_parts_calls_per_step": {
            n: sp.get(n, {}).get("calls", 0) / steps for n in LINSOLVE_PARTS},
        "linsolve.calls_per_step": solves / steps,
        "graphs_by_site": graphs,
        "graph_ms_by_site": {n: ms(n) for n in sp if n.startswith("graph/")},
        "linsolve.graph_hit_pct": (
            100 * sp.get("graph/solve_schur.replay", {}).get("calls", 0)
            / solves if solves else None),
        "pcg.calls_per_step": sp.get(K4_SPAN, {}).get("calls", 0) / steps,
        "pcg.iters_per_call": (counts.get("pcg/iters", 0) / pcg_scenarios
                               if pcg_scenarios else None),
        "syncs_by_site": syncs,
        "sync_wait_ms_by_site": {n: ms(n) for n in sp if n.startswith("sync/")},
        "accounted_pct": 100 * sum(s["self_ns"] for s in sp.values())
        / sp["MPCController.run"]["ns"],
    }


def off_path_ns(spans, torch, n=200_000):
    """Nanoseconds per call on this host (best of 5): ``with span()``,
    a ``traced`` function, ``host_bool`` on a CPU flag and ``bool`` alone,
    tracing off, then the first three with tracing on (totals reset)."""
    import timeit
    flag = torch.tensor(True)

    def with_span():
        with spans.span("x"):
            pass

    @spans.traced("y")
    def traced():
        pass

    cases = {"span": with_span, "traced": traced,
             "host_bool": lambda: spans.host_bool(flag, "z"),
             "bool": lambda: bool(flag)}
    out = {}
    for on in (False, True):
        spans.enable(on)
        for name, fn in cases.items():
            if on and name == "bool":
                continue
            out[f"{name}_{'on' if on else 'off'}"] = min(
                timeit.timeit(fn, number=n) for _ in range(5)) / n * 1e9
    spans.enable(False)
    spans.reset()
    return out


class GCPauses:
    """A ``gc.callbacks`` entry: sums the collections' pauses, and while
    a profiler runs, opens a ``gc/gen<n>`` span around each collection."""

    def __init__(self, torch):
        self.torch, self.seconds, self.rf, self.t0 = torch, 0.0, None, 0.0

    def __call__(self, phase, info):
        if phase == "start":
            if self.torch.autograd._profiler_enabled():
                self.rf = self.torch.profiler.record_function(
                    f"gc/gen{info['generation']}")
                self.rf.__enter__()
            self.t0 = time.perf_counter()
        else:
            self.seconds += time.perf_counter() - self.t0
            if self.rf is not None:
                self.rf.__exit__(None, None, None)
                self.rf = None


def idle_by_span(stretch, merged):
    """Idle seconds of the stretch under each innermost host span (full
    name), and the ten longest gaps with the spans around their
    midpoints."""
    spans_ = sorted(stretch.host_spans, key=lambda h: (h[1], -h[2]))
    points = sorted({t for _, s, e in spans_ for t in (s, e)}
                    | {stretch.start, stretch.end})

    def chain(t):
        return [n for n, s, e in spans_ if s <= t < e]

    # the innermost span of each elementary segment between span edges
    inner = []
    for a, b in zip(points, points[1:]):
        c = chain(0.5 * (a + b))
        inner.append(c[-1] if c else "outside spans")
    busy = merged(((o.start, o.end) for o in stretch.ops), stretch.start,
                  stretch.end)
    edges = [stretch.start] + [t for iv in busy for t in iv] + [stretch.end]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    by = collections.Counter()
    for s, e in gaps:
        i = max(bisect.bisect_right(points, s) - 1, 0)
        while i < len(inner) and points[i] < e:
            lo, hi = max(s, points[i]), min(e, points[i + 1])
            if hi > lo:
                by[inner[i]] += hi - lo
            i += 1
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    longest = [{"ms": 1e3 * (e - s), "at": chain(0.5 * (s + e))}
               for s, e in gaps[:10]]
    return by, longest


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cells", nargs="+", default=list(CELLS))
    p.add_argument("--seed", type=int, default=2_718_281_828)
    p.add_argument("--pairs", type=int, default=40,
                   help="pairs of an untraced and a host-timed step")
    p.add_argument("--repeats", type=int, default=1,
                   help="profiled stretches of each kind")
    p.add_argument("--device", default="cuda")
    p.add_argument("--batch", type=int, default=None,
                   help="override the traffic's batch (CPU rehearsal)")
    p.add_argument("--out", default=str(ROOT / "build" / "host_spans.jsonl"),
                   help="where the JSON lines go (appended)")
    args = p.parse_args(argv)

    sys.path[:0] = [str(ROOT / "benchmark"), str(ROOT)]
    import torch

    from trajoptmpcreference_tpu_torch.utils import spans

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("host_spans: no CUDA device", file=sys.stderr)
        return 1
    torch.set_num_threads(1)
    card = "cpu"
    if device.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    os.makedirs(os.path.dirname(args.out), exist_ok=True)

    def emit(line):
        with open(args.out, "a") as f:
            f.write(json.dumps(line) + "\n")

    micro = off_path_ns(spans, torch)
    emit({"off_path_ns": micro, "card": card})
    print(f"[off path] {card}: ns per call {json.dumps(micro)}", flush=True)
    pauses = GCPauses(torch)
    gc.callbacks.append(pauses)
    try:
        for name in args.cells:
            measure_cell(name, args, card, device, pauses, emit)
    finally:
        gc.callbacks.remove(pauses)
    return 0


def measure_cell(name, args, card, device, pauses, emit):
    """One cell: the pairs, the profiled stretches, one JSON line."""
    import torch

    from benchlib import stats
    from benchlib import trace as TR
    from benchlib.loop import ClosedLoop
    from benchlib.manifest import Cell
    from trajoptmpcreference_tpu_torch.utils import spans

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    cell = Cell(name)
    cfg, tr = cell.config, dict(cell.traffic)
    if args.batch:
        tr["batch"] = args.batch
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg["tf32"])
    loop = ClosedLoop(cfg, tr, args.seed, device)
    loop.new_episode(0)
    for _ in range(loop.cold_steps + tr["warmup_steps"]):
        loop.step()
    loop.new_episode(0)
    sync()
    gc.collect()
    gc.freeze()
    T = tr["trace"]["steps"]

    def run(n, wrap=None):
        times = []
        for _ in range(n):
            if loop.episode_done:
                loop.new_episode(loop.episode + 1)
            t0 = time.perf_counter()
            if wrap is None:
                loop.step()
            else:
                with wrap():
                    loop.step()
            times.append(time.perf_counter() - t0)
        return times

    # skip the episode's cold step: every timed step is a steady one
    run(loop.cold_steps)
    plain, traced = [], []
    spans.reset()
    pauses.seconds = 0.0
    for _ in range(args.pairs):
        plain += run(1)
        spans.enable(True)
        traced += run(1)
        spans.enable(False)
    host = per_step(spans.snapshot())
    gc_pairs_ms = 1e3 * pauses.seconds / (2 * args.pairs)
    plain_s = statistics.mean(plain)
    on_cost = 100 * (statistics.mean(traced) / plain_s - 1)
    on_cost_median = 100 * (statistics.median(
        b / a for a, b in zip(plain, traced)) - 1)

    profiled = {}
    kinds = [(f"{label}#{i}" if i else label, port)
             for i in range(args.repeats)
             for label, port in (("harness", False), ("harness+port", True))]
    for label, port in kinds:
        pauses.seconds = 0.0
        with TR.spans():
            spans.enable(port)
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            with prof:
                run(T, lambda: torch.profiler.record_function(TR.STEP_SPAN))
            spans.enable(False)
        gc_s = pauses.seconds
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            stretch = TR.parse_chrome_trace(TR.load_trace(path), T)
        layer_ms = collections.Counter()
        for o in stretch.ops:
            layer_ms[o.layer or "other"] += 1e3 * o.seconds / T
        entry = {"steps": T, "device_ops_per_step": len(stretch.ops) / T,
                 "busy_ms_per_step": 1e3 * stretch.busy_s / T,
                 "wall_ms_per_step": 1e3 * stretch.window_s / T,
                 "device_ms_by_layer": dict(layer_ms),
                 "gc_ms_per_step": 1e3 * gc_s / T}
        if stretch.ops:
            entry["idle_pct"] = stats.idle_pct(stretch.busy_s / T, plain_s)
        by, longest = idle_by_span(stretch, stats.merged)
        entry["longest_gaps"] = longest
        if port:
            entry["idle_ms_per_step_by_span"] = {
                n: 1e3 * s / T for n, s in by.most_common(15)}
        profiled[label] = entry

    line = {"cell": name, "card": card, "seed": args.seed,
            "batch": tr["batch"], "plain_steps": len(plain),
            "plain_step_ms": 1e3 * plain_s,
            "traced_step_ms": 1e3 * statistics.mean(traced),
            "on_cost_pct": on_cost, "on_cost_median_pct": on_cost_median,
            "gc_ms_per_step": gc_pairs_ms,
            "host": host, "profiled": profiled}
    emit(line)
    h = host
    print(f"[{name}] {card}; B={tr['batch']}: untraced step "
          f"{line['plain_step_ms']:.3f} ms, host-timed "
          f"{line['traced_step_ms']:.3f} ms (on-cost {on_cost:+.3f}%, "
          f"median of pairs {on_cost_median:+.3f}%); per step: run "
          f"{h['step_ms']:.3f} ms = kkt {h['kkt.host_ms_per_step']:.3f} + "
          f"linsolve {h['linsolve.host_ms_per_step']:.3f} + linesearch "
          f"{h['linesearch.host_ms_per_step']:.3f} + sqp self "
          f"{h['sqp.host_self_ms_per_step']:.3f} + mpc self "
          f"{h['mpc.host_self_ms_per_step']:.3f} + waits "
          f"{h['host.sync_wait_ms_per_step']:.3f} ms; syncs "
          f"{h['host.syncs_per_step']:.2f}; accounted "
          f"{h['accounted_pct']:.3f}%", flush=True)
    hit = h["linsolve.graph_hit_pct"]
    print(f"[{name}] solve_schur {h['linsolve.calls_per_step']:.2f} calls a "
          f"step, graph calls a step {json.dumps(h['graphs_by_site'])}, "
          f"replayed {'-' if hit is None else f'{hit:.2f}%'}; parts (absent "
          f"on replayed calls): ms a step "
          f"{json.dumps({k: round(v, 3) for k, v in h['linsolve_parts_ms'].items()})}, "
          f"calls a step {json.dumps(h['linsolve_parts_calls_per_step'])}",
          flush=True)
    if h["pcg.iters_per_call"] is not None:
        print(f"[{name}] K4 {h['pcg.calls_per_step']:.2f} calls a step, "
              f"{h['pcg.iters_per_call']:.3f} iterations per scenario per "
              f"call", flush=True)
    for label, e in profiled.items():
        print(f"[{name}] profiled ({label}): idle "
              f"{e.get('idle_pct', float('nan')):.2f}%, device ms by "
              f"layer {json.dumps({k: round(v, 3) for k, v in e['device_ms_by_layer'].items()})}; "
              f"longest gap {e['longest_gaps'][0] if e['longest_gaps'] else None}",
              flush=True)
    del loop
    gc.unfreeze()
    if device.type == "cuda":
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
