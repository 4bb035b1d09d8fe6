"""Drive the PyTorch + CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py            # on a machine with a CUDA card

Phases (each prints its own numbers; any failure exits non-zero):

1. toolchain: torch / CUDA / nvcc versions, card name and power limit;
2. build: nvcc compiles kernels K1-K3 (csrc/*.cu) for sm_90a;
3. each kernel against its plain PyTorch version on the card, f32, at the
   main path's lane counts and a ragged one;
4. each kernel's time beside its plain version's (CUDA events, median of 20);
5. in-situ: one KKT assembly and one full SQP solve of the flagship with
   the kernels on vs off;
6. the main path: the flagship closed loop (6-DoF arm, N = 64, B = 512
   scenarios of bench.py, f32): one cold block-Thomas step, then 149
   cyclic-reduction steps through run_scheduled, with the kernels' launch
   counts and the bench's quality gate.

The last line is {"ok": true, "device": {...}}; the line before it lists
the kernels as JSON.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

B, N, STEPS, COLD_STEPS = 512, 64, 150, 1
L_MAIN = B * (N - 1)                      # 32,256 lanes per knot sweep
L_RAGGED = 1000                           # not a multiple of the block size
L_LADDER = 3 * L_MAIN                     # the 3-rung ladder's K2 call
TOL = {"fd_grad": 1e-4, "fd": 1e-4, "task_vec": 1e-5}   # the JAX package's own


def log(msg):
    print(msg, flush=True)


def gpu_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def rel_err(out, ref):
    return float((out - ref).abs().max() / ref.abs().max())


def cuda_ms(fn, reps=20):
    """Median of ``reps`` single-call times from CUDA events (ms)."""
    import torch
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


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from trajoptmpcreference_tpu_torch import flagship as F
    from trajoptmpcreference_tpu_torch.kernels import _build
    from trajoptmpcreference_tpu_torch.models.plants import URDFPlant
    from trajoptmpcreference_tpu_torch.models.urdf import serial_arm
    from trajoptmpcreference_tpu_torch.ops import kinematics as K
    from trajoptmpcreference_tpu_torch.ops import lanes
    from trajoptmpcreference_tpu_torch.solvers.sqp import knot_params

    # ---- 1. toolchain; f32 matmuls stay full f32 (TF32 off)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    dev = torch.device("cuda", 0)
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    log(f"[toolchain] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} nvcc '{nvcc}' device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    log(gpu_line())

    # ---- 2. build
    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"[build] {time.perf_counter() - t0:.1f} s wall; per library "
        + json.dumps({k: round(v, 1) for k, v in built.items()})
        + f"; dir {_build.build_dir()}")
    for name in _build.LIBRARIES:
        log(f"[ptxas] {name} (f32, n=6): "
            + ptxas_summary(_build.ptxas_report(name)))

    # ---- 3. kernels vs plain versions (f32, on the card)
    plant = URDFPlant(robot=serial_arm(6))
    robot, dyn, kin = plant.robot, plant.dynamics, plant.kinematics
    f32 = torch.float32

    def inputs(L, seed):
        rng = np.random.default_rng(seed)
        return [torch.as_tensor(0.3 * rng.standard_normal((6, L)), dtype=f32,
                                device=dev) for _ in range(3)]

    kernels = {
        "fd_grad": (lambda q, qd, u: lanes.fd_grad_kernel(dyn.packed(q), 6, q, qd, u),
                    lambda q, qd, u: lanes.fd_grad_lanes(robot, q, qd, u, consts=dyn.consts(q)),
                    [L_MAIN, L_RAGGED]),
        "fd": (lambda q, qd, u: lanes.fd_kernel(dyn.packed(q), 6, q, qd, u),
               lambda q, qd, u: lanes.fd_lanes(robot, q, qd, u, consts=dyn.consts(q)),
               [L_MAIN, L_RAGGED, L_LADDER]),
        "task_vec": (lambda q, qd, u: K.task_vec_kernel(kin.packed(q), 6, q, qd),
                     lambda q, qd, u: kin.task_vec_L(q, qd),
                     [L_MAIN, L_RAGGED]),
    }
    max_abs = {}
    for name, (kern, plain, Ls) in kernels.items():
        for i, L in enumerate(Ls):
            q, qd, u = inputs(L, 74 + i)
            out, ref = kern(q, qd, u), plain(q, qd, u)
            torch.cuda.synchronize()
            assert out.shape == ref.shape, (name, out.shape, ref.shape)
            assert bool(torch.isfinite(out).all()), name
            rel = rel_err(out, ref)
            if L == L_MAIN:
                max_abs[name] = float((out - ref).abs().max())
            log(f"[check] {name} L={L}: max|d|/max|ref| = {rel:.3e} "
                f"(limit {TOL[name]:.0e})")
            assert rel < TOL[name], (name, L, rel)

    # ---- 4. kernel times at the main path's lane count
    ms, plain_ms = {}, {}
    for name, (kern, plain, _) in kernels.items():
        q, qd, u = inputs(L_MAIN, 90)
        plain_ms[name] = cuda_ms(lambda: plain(q, qd, u))
        ms[name] = cuda_ms(lambda: kern(q, qd, u))
        log(f"[time] {name} L={L_MAIN}: kernel {ms[name]:.4f} ms, plain "
            f"{plain_ms[name]:.4f} ms (median of 20, CUDA events)")

    # ---- 5. in-situ: the flagship's KKT blocks and one solve, kernels on/off
    x0s_np, goals_np = F.bench_scenarios(B)
    x0s = torch.as_tensor(x0s_np, dtype=f32, device=dev)
    goals = torch.as_tensor(goals_np, dtype=f32, device=dev)
    X0 = x0s[..., None].expand(B, 12, N).contiguous()
    U0 = torch.zeros((B, 6, N - 1), dtype=f32, device=dev)
    solvers = {on: F.flagship(N=N, dtype=f32, device=dev, use_kernels=on)
               for on in (True, False)}
    blocks = {}
    for on, (plant, cost, solver) in solvers.items():
        p = knot_params(cost.default_params._replace(xg=goals))
        blocks[on] = solver.kkt.form_blocks(X0, U0, x0s, p, ())
    for field in ("H", "g", "A", "B", "defect"):
        a, b = getattr(blocks[True], field), getattr(blocks[False], field)
        rel = rel_err(a, b)
        log(f"[in-situ] form_blocks {field}: rel {rel:.3e} (limit 1e-4)")
        assert rel < 1e-4, (field, rel)
    sols = {}
    for on, (plant, cost, solver) in solvers.items():
        sols[on] = solver.solve(X0, U0, cost.default_params._replace(xg=goals))
    dU = float((sols[True].U - sols[False].U).abs().max())
    log(f"[in-situ] solve kernels on vs off: max|dU| = {dU:.3e} (reported), "
        f"exit codes on {sols[True].exit_sqp.bincount().tolist()} off "
        f"{sols[False].exit_sqp.bincount().tolist()}")

    # ---- 6. the main path
    launched = (lanes.fd_grad_kernel, lanes.fd_kernel, K.task_vec_kernel)
    torch.cuda.synchronize()
    for k in launched:
        k.launches = 0
    t0 = time.perf_counter()
    plant, res = F.run_episode(x0s, goals, steps=STEPS, cold_steps=COLD_STEPS,
                               N=N)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"fd_grad": lanes.fd_grad_kernel.launches,
              "fd": lanes.fd_kernel.launches,
              "task_vec": K.task_vec_kernel.launches}
    err, dist0 = F.ee_errors(plant, x0s, goals, res)
    gate_ok, med_err, stable = F.quality_gate(err, dist0)
    finite = bool(torch.isfinite(res.X_applied).all()
                  and torch.isfinite(res.U_applied).all())
    log(f"[main] flagship B={B} N={N} {STEPS} steps ({COLD_STEPS} cold "
        f"thomas + {STEPS - COLD_STEPS} cr), f32: wall {wall:.3f} s, "
        f"{B * STEPS / wall:.1f} solves/s, {1e3 * wall / STEPS:.2f} ms/step; "
        f"launches {json.dumps(counts)}; iters/step mean "
        f"{res.iters.float().mean().item():.3f}")
    log(f"[main] quality: median EE err {med_err:.4f} m from "
        f"{float(np.median(dist0)):.2f} m, {stable}/{B} stable<1m, "
        f"states finite {finite}, gate {'passed' if gate_ok else 'FAILED'}")
    assert all(v > 0 for v in counts.values()), counts
    assert finite
    assert res.X_applied.shape == (B, 12, STEPS + 1)
    assert gate_ok, (med_err, float(np.median(dist0)))

    replaces = {"fd_grad": "trajoptmpcreference_tpu/ops/lanes.py:444",
                "fd": "trajoptmpcreference_tpu/ops/lanes.py:486",
                "task_vec": "trajoptmpcreference_tpu/ops/kinematics.py:283"}
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"trajoptmpcreference_tpu_torch/kernels/csrc/{name}.cu",
         "replaces": replaces[name], "launches": counts[name],
         "max_abs_err": max_abs[name], "ms": ms[name],
         "plain_ms": plain_ms[name]} for name in kernels]}))
    log(gpu_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def ptxas_summary(report: str) -> str:
    """Registers / spills of the float, n = 6 instantiation (the main path)."""
    out, current = [], None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            current = "IfLi6E" in line
        elif current and ("registers" in line or "spill" in line):
            out.append(" ".join(line.replace("ptxas info    :", "").split()))
    return "; ".join(out) or "no ptxas report"


if __name__ == "__main__":
    sys.exit(main())
