"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload arm6_s.b512 --seed 7 --seconds 30 --trace 0

From the root of a checkout: loads the cell named in BENCHMARK.json, builds
the port's closed-loop MPC from the cell's configuration file, warms it up
on the cell's own shapes, runs control steps for ``--seconds``, checks
sampled steps against the plain reference, and prints the end-to-end
metrics (``--trace 0``) or the per-layer metrics of a profiled stretch of
steps (``--trace 1``) as the last line of standard output, one JSON
object.  Exits non-zero with no result line without enough CUDA devices,
or when JAX or the JAX package was loaded.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

BENCH = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def host_state():
    """What the host was like, for the record beside each run: the CPU the
    process runs on, the mean clock its cores report, and the seconds a
    fixed pure-Python loop takes (the pace of the host work that sets a
    dispatch-bound step)."""
    t0 = time.perf_counter()
    acc = 0
    for i in range(1_000_000):
        acc += i & 7
    out = {"probe_s": time.perf_counter() - t0}
    try:
        with open("/proc/self/stat") as f:
            out["on_cpu"] = int(f.read().rsplit(")", 1)[1].split()[36])
        with open("/proc/cpuinfo") as f:
            mhz = [float(ln.split(":")[1]) for ln in f if ln.startswith("cpu MHz")]
        out["mhz_mean"] = sum(mhz) / len(mhz)
    except (OSError, ValueError, IndexError, ZeroDivisionError):
        pass
    return out


def log_host(before, after):
    """One stderr line: the host before and after the window."""
    log(f"[host] probe {before['probe_s']:.4f} s before, "
        f"{after['probe_s']:.4f} s after; on cpu {before.get('on_cpu')} then "
        f"{after.get('on_cpu')} of {len(os.sched_getaffinity(0))}; mean core "
        f"clock {after.get('mhz_mean', float('nan')):.0f} MHz")


def warm_up(loop, steps: int):
    """One cold step and ``steps`` steady steps on episode 0: every shape
    the window runs, and every kernel library loaded."""
    loop.new_episode(0)
    for _ in range(loop.cold_steps + steps):
        loop.step()
    loop.new_episode(0)


def end_to_end(cell, win, setup_s):
    import numpy as np
    import torch

    from benchlib import stats
    from reference.arm import PlanarArm
    tr = cell.traffic
    cfg = cell.config
    step_ms = [1e3 * s for s in win.step_s]
    vals = {"solves_per_s": stats.solves_per_s(tr["batch"], win.steps,
                                               win.window_s),
            "step_ms_p95": stats.percentile(step_ms, 95),
            "setup_s": setup_s}
    log(f"[steps] {win.steps} steps in {win.window_s:.4f} s; step ms p50 "
        f"{stats.percentile(step_ms, 50):.4f} p95 {vals['step_ms_p95']:.4f} "
        f"max {max(step_ms):.4f}; episodes completed {len(win.finals)}")
    if win.finals:
        # the window's first episode, which every run completes: how many
        # episodes a run completes does not move the number
        x0, goals, xf = win.finals[0]
        arm = PlanarArm(cfg["robot"], cfg["dt"], cfg["sim_qd_max"])
        g = goals[:, :2].double()
        err = torch.linalg.norm(arm.ee_xy(xf.double()) - g, dim=1)
        dist0 = torch.linalg.norm(arm.ee_xy(x0.double()) - g, dim=1)
        err, dist0 = err.cpu().numpy(), dist0.cpu().numpy()
        finite = np.isfinite(err)
        med = float(np.median(np.where(finite, err, np.inf)))
        vals["ee_err_mm"] = 1e3 * med
        log(f"[quality] first episode: median final EE error {med:.6f} m over "
            f"{err.size} scenarios; stable (finite, < 1 m) "
            f"{int((finite & (err < 1)).sum())}/{err.size}; gate (median < "
            f"0.25 x median initial distance {float(np.median(dist0)):.4f} "
            f"m): {med < 0.25 * float(np.median(dist0))}")
    units = {m["name"]: m["unit"] for m in cell.end_to_end}
    return {name: {"value": vals[name], "unit": units[name]}
            for name in units if name in vals}


def per_layer(cell, win):
    import torch

    from benchlib import manifest, trace
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        win.profile.export_chrome_trace(path)
        stretch = trace.parse_chrome_trace(trace.load_trace(path),
                                           cell.traffic["trace"]["steps"])
    traced = range(win.trace_at, win.trace_at + win.trace_steps)
    untraced = [t for g, t in enumerate(win.step_s) if g not in traced]
    run = Record(cell=cell, stretch=stretch,
                 iters=torch.cat(win.iters).double().mean().item(),
                 step_s=sum(untraced) / len(untraced),
                 peaks=manifest.load_json(manifest.HERE / "peaks.json"))
    log(f"[trace] {stretch.steps} steps, {len(stretch.ops)} device "
        f"operations, busy {stretch.busy_s:.6f} of {stretch.window_s:.6f} s; "
        f"K1-K3 tied to their launches by {stretch.kernel_link}")
    out = {}
    for m in cell.per_layer:
        v = cell.reader(m["name"])(run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"busy_s": stretch.busy_s, "window_s": stretch.window_s}
    return out, dev, stretch.breakdown()


class Record:
    """What a per-layer reader reads: the cell, the traced stretch, the
    window's mean SQP iterations, its mean step time on the host clock
    outside the stretch (the profiler slows the stretch's host side) and
    the table of peaks."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def main(argv=None) -> int:
    args = parse(argv)
    from benchlib.manifest import Cell
    cell = Cell(args.workload)
    import torch
    need = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        log(f"needs {need} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    return measure(cell, args, torch.device("cuda", 0))


def measure(cell, args, device) -> int:
    import numpy as np
    import torch

    from benchlib import correct, imports
    from benchlib.loop import ClosedLoop, Window
    cfg, tr = cell.config, cell.traffic
    # one host thread: the step's host work is Python dispatch, and idle
    # intra-op workers only add noise to the host clock
    torch.set_num_threads(1)
    tf32 = bool(cfg["tf32"])
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    if (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) != (tf32, tf32):
        raise RuntimeError(f"TF32 flags did not take the configuration's {tf32}")
    loop = ClosedLoop(cfg, tr, args.seed, device)
    warm_up(loop, tr["warmup_steps"])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.monotonic() - T_START
    # set-up's objects leave the collector's reach: no collection inside
    # the window walks them
    gc.collect()
    gc.freeze()
    rng = np.random.default_rng([args.seed % 2**64, 2**32 - 1])
    win = Window(loop, args.seconds, rng, tr["check"],
                 trace_at=tr["trace"]["skip"] if args.trace else None,
                 trace_steps=tr["trace"]["steps"])
    host0 = host_state()
    win.run()
    log_host(host0, host_state())
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
        kind = torch.cuda.get_device_name(device)
    else:
        peak, kind = 0, "cpu"
    attempted = tr["batch"] * win.steps
    failed = int(torch.stack(win.bad).sum().item())
    result = {"attempted": attempted, "failed": failed}
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": kind, "count": cell.workload["chips"],
                   "memory_peak_bytes": int(peak)}
    if args.trace:
        metrics, extra, breakdown = per_layer(cell, win)
        device_info.update(extra)
    else:
        metrics = end_to_end(cell, win, setup_s)
    samples = win.samples_for_check()
    del win.reservoir, win.first, loop.carry
    if device.type == "cuda":
        torch.cuda.empty_cache()
    truth = correct.reference_answers(samples, cfg, torch.float64, device)
    g = correct.gaps(samples, correct.program_answers(samples), truth, cfg,
                     win.runaway)
    checks = correct.judge(g, cell.limits)
    ok = all(v["value"] <= v["limit"] for v in checks.values())
    log(f"[check] {len(samples)} steps, {g['x1'].size} scenario-steps "
        f"({int(g['cold'].sum())} cold) against the float64 reference")
    for name, v in checks.items():
        log(f"[check] {name} {v['value']!r} limit {v['limit']!r}")
    bad = imports.forbidden_loaded()
    if bad:
        log(f"loaded in this process: {', '.join(bad)}; no result")
        return 3
    out = {"correct": bool(ok), **result, "metrics": metrics,
           "device": device_info}
    if args.trace:
        out["breakdown"] = breakdown
    out["checks"] = checks
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
