"""Read the correctness check's numbers for the program and for its
control over many seeds in one process, on the card, at the cell's own
size.

    python3 benchmark/control.py --workload arm6_s.b512 --seeds 1 2 3 \
        --seconds 8 --out chiprun_out/control

For each seed, a window of the timed path at the cell's own load (as
``run.py`` runs it, the same kept steps), then every number of
``benchlib.correct.NUMBERS`` against the float64 reference for the
program's answers and for the control's (the reference in the program's
place, in float32 with TF32 on), and the harness's verdict (``correct``)
on each side by the cell's limits; with ``--f32`` also for the reference in
float32 with TF32 off, and with ``--faults`` for the program's own step
from the same inputs with each fault of ``benchlib/faults.py`` planted.
The limits in ``limits/<cell>.json`` are set from these readings
(PERF.md gives them); the benchmark's own runs do not run this.
"""

import argparse
import json
import pathlib
import sys
import time

BENCH = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--f32", action="store_true")
    p.add_argument("--faults", nargs="*", default=[])
    p.add_argument("--side-seeds", type=int, default=None,
                   help="take the control, --f32 and --faults on the first "
                        "this many seeds only (default: every seed)")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import numpy as np
    import torch

    import run
    from benchlib import correct, faults
    from benchlib.loop import ClosedLoop, Window, replay
    from benchlib.manifest import Cell
    cell = Cell(args.workload)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cfg, tr = cell.config, cell.traffic
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    loop = ClosedLoop(cfg, tr, args.seeds[0], dev)
    run.warm_up(loop, tr["warmup_steps"])
    out_dir = pathlib.Path(args.out) if args.out else None
    if out_dir:
        out_dir.mkdir(parents=True, exist_ok=True)
    rows = []
    for seed in args.seeds:
        loop.seed = seed
        loop.new_episode(0)
        rng = np.random.default_rng([seed % 2**64, 2**32 - 1])
        win = Window(loop, args.seconds, rng, tr["check"])
        win.run()
        samples = win.samples_for_check()
        t0 = time.perf_counter()
        truth = correct.reference_answers(samples, cfg, torch.float64, dev)
        torch.cuda.synchronize()
        t_ref = time.perf_counter() - t0
        sides = {"program": correct.program_answers(samples)}
        if args.side_seeds is None or seed in args.seeds[:args.side_seeds]:
            sides["control"] = correct.control_answers(samples, cfg, dev)
            if args.f32:
                sides["reference_f32"] = correct.reference_answers(
                    samples, cfg, torch.float32, dev)
            for fault in args.faults:
                with faults.planted(fault):
                    sides[f"fault_{fault}"] = replay(loop, samples)
        for side, ans in sides.items():
            g = correct.gaps(samples, ans, truth, cfg)
            nums = {k: f(g) for k, f in correct.NUMBERS.items()}
            # the harness's own verdict on this side, by the cell's limits
            checks = correct.judge(g, cell.limits)
            ok = all(v["value"] <= v["limit"] for v in checks.values())
            rows.append(dict(seed=seed, side=side, correct=ok,
                             steps=win.steps, window_s=win.window_s,
                             scenario_steps=int(g["x1"].size),
                             reference_s=t_ref, **nums))
            print(json.dumps(rows[-1]), flush=True)
            if out_dir:
                np.savez(out_dir / f"{args.workload}.{seed}.{side}.npz", **g)
    if out_dir:
        (out_dir / f"{args.workload}.readings.json").write_text(
            json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
