"""Drive the PyTorch + CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py            # on a machine with a CUDA card

Phases (each prints its own numbers; any failure exits non-zero):

1. toolchain: torch / CUDA / nvcc versions, card name and power limit;
2. build: nvcc compiles kernels K1-K4 (csrc/*.cu) for sm_90a, in parallel,
   and g++ the operation counters (kernels/opcount.py): K1-K3's functions
   as they need to be computed (kernels/needed_ops.cpp, each value once),
   whose counts give their bounds, and the kernels' own sources;
3. each of K1-K3 against its plain PyTorch version on the card, f32, at
   the main path's lane counts and a ragged one (K2 at all four of its
   lane counts, 512 to 290,304); K4 (the fused PCG)
   against its plain version for J, BJ and SS on SPD and negative-definite
   systems at B = 512, N = 64, bs = 12 (20 fixed iterations, and run to
   convergence against cyclic reduction), on ragged batches, in f64, and
   its shared-memory limit;
4. each kernel's time beside its plain version's and its bound, median of
   20, with two timers (kernels/timing.py): CUDA events around one call
   (``ms``, the yardstick of earlier runs) and device time behind a spin
   (``device_ms``); K2 at each of its lane counts.  The bound is the
   larger of bytes / 3.35 TB/s and needed operations / 67 TFLOP/s (f32 off
   the tensor cores), the H100 SXM data sheet's peaks at 700 W;
5. in-situ: one KKT assembly and one full SQP solve of the flagship with
   the kernels on vs off; K4 and its plain version on the flagship's
   cold-start Schur systems (relative residuals, iteration counts);
6. the main path: the flagship closed loop (6-DoF arm, N = 64, B = 512
   scenarios of bench.py, f32): one cold block-Thomas step, then 149
   cyclic-reduction steps through run_scheduled, with the kernels' launch
   counts (split by lane count), each kernel's episode-weighted device
   time and bound (launches x time, launches x bound, at each lane count),
   the loss between them, and the bench's quality gate;
7. the PCG-SS closed loop (flagship.PCG_KNOBS, K4 on): the same episode
   with 4 SQP iterations per step and the Schur systems solved by PCG-SS,
   with K1-K4's launch counts and the quality gate.

The last line is {"ok": true, "device": {...}}; the line before it lists
the kernels as JSON.
"""

import collections
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

B, N, STEPS, COLD_STEPS = 512, 64, 150, 1
L_MAIN = B * (N - 1)                      # 32,256 lanes per knot sweep
L_RAGGED = 1000                           # not a multiple of the block size
L_LADDER = 3 * L_MAIN                     # the 3-rung ladder's K2 call
L_SIM = B                                 # the MPC sim step's K2 call
L_COLD = 9 * L_MAIN                       # the cold step's 9-rung ladder
K2_LANES = [L_SIM, L_RAGGED, L_MAIN, L_LADDER, L_COLD]
# H100 SXM peaks (data sheet, 700 W): f32 off the tensor cores, HBM3
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12
TOL = {"fd_grad": 1e-4, "fd": 1e-4, "task_vec": 1e-5}   # the JAX package's own
# K4 vs its plain version, f32: max|d|/max|ref| after 20 fixed iterations,
# and each scenario's max|x - x_cr|/max|x_cr| after running to convergence
PCG_TOL, PCG_BS, PCG_FIXED_ITERS = 1e-4, 12, 20
# the convergence run's relative exit on nu = r' Pinv r: 1e-8 would bound
# the residual only to ~1e-4 (nu ~ |r|^2), so the error could reach the bar
PCG_CONV_TOL, PCG_CONV_ITERS = 1e-12, 200
REPLACES = {"fd_grad": "trajoptmpcreference_tpu/ops/lanes.py:444",
            "fd": "trajoptmpcreference_tpu/ops/lanes.py:486",
            "task_vec": "trajoptmpcreference_tpu/ops/kinematics.py:283",
            "pcg": "trajoptmpcreference_tpu/ops/pallas_pcg.py:123"}


def log(msg):
    print(msg, flush=True)


def gpu_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def rel_err(out, ref):
    return float((out - ref).abs().max() / ref.abs().max())


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from trajoptmpcreference_tpu_torch import flagship as F
    from trajoptmpcreference_tpu_torch.kernels import _build, opcount
    from trajoptmpcreference_tpu_torch.kernels.timing import device_ms, events_ms
    from trajoptmpcreference_tpu_torch.models.plants import URDFPlant
    from trajoptmpcreference_tpu_torch.models.urdf import serial_arm
    from trajoptmpcreference_tpu_torch.ops import btridiag as BT
    from trajoptmpcreference_tpu_torch.ops import fused_pcg as FP
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
    with ThreadPoolExecutor(2) as pool:
        counting = pool.submit(opcount.build_all)
        built = _build.build_all()
        counting.result()
    log(f"[build] {time.perf_counter() - t0:.1f} s wall (nvcc and the g++ "
        "operation counters together); per library "
        + json.dumps({k: round(v, 1) for k, v in built.items()})
        + f"; dir {_build.build_dir()}")
    for name in ("fd", "fd_grad", "task_vec"):
        extra = ""
        if name == "fd":
            extra = ("; dynamic shared memory per block at n=6: "
                     f"{lanes.fd_smem_bytes(6, torch.float32)} bytes f32, "
                     f"{lanes.fd_smem_bytes(6, torch.float64)} bytes f64")
        log(f"[ptxas] {name} (f32, n=6): "
            + ptxas_summary(_build.ptxas_report(name), "IfLi6E") + extra)
    for tag, dt in (("f32", torch.float32), ("f64", torch.float64)):
        key = "pcg_kernelI" + ("f" if tag == "f32" else "d") + "E"
        log(f"[ptxas] pcg ({tag}): "
            + ptxas_summary(_build.ptxas_report("pcg"), key)
            + f"; dynamic shared memory {FP.smem_bytes(N, PCG_BS, dt)} bytes "
            f"per block at N={N}, bs={PCG_BS}")

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
               K2_LANES),
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
            del out, ref
            log(f"[check] {name} L={L}: max|d|/max|ref| = {rel:.3e} "
                f"(limit {TOL[name]:.0e})")
            assert rel < TOL[name], (name, L, rel)

    max_abs["pcg"] = check_pcg(torch, BT, FP, dev)

    # ---- 4. kernel times at the main path's lane count (K4: B = 512 SS
    # systems, 40 fixed iterations), each beside its bound
    packed6 = dyn.packed(torch.zeros(1, dtype=f32, device=dev))
    per_lane = {name: opcount.count_needed(name, packed6, 6)
                for name in ("fd", "fd_grad", "task_vec")}
    done = {name: opcount.count_lanes(name, packed6, 6) for name in per_lane}
    log("[bound] operations per lane at n=6, a multiply-add counted as 2: "
        f"the functions need {json.dumps(per_lane)} (kernels/needed_ops.cpp, "
        f"the bounds' count); the kernels do {json.dumps(done)} "
        "(their own sources, every thread of a group)")
    rows = {"fd": 6, "fd_grad": 3 * 36, "task_vec": 6}   # outputs per lane
    ins = {"fd": 18, "fd_grad": 18, "task_vec": 12}       # inputs per lane
    bounds = {}

    def lane_bound(name, L):
        """(bound ms, what binds) for one call over L lanes in f32."""
        by_ops = per_lane[name] * L / PEAK_FLOPS
        by_bytes = 4 * (ins[name] + rows[name]) * L / PEAK_BYTES
        return (1e3 * max(by_ops, by_bytes),
                "operations" if by_ops >= by_bytes else "bytes")

    ms, dev_ms, plain_ms = {}, {}, {}
    for name, (kern, plain, _) in kernels.items():
        q, qd, u = inputs(L_MAIN, 90)
        plain_ms[name] = events_ms(lambda: plain(q, qd, u))
        ms[name] = events_ms(lambda: kern(q, qd, u))
        dev_ms[name] = device_ms(lambda: kern(q, qd, u))
        bounds[name] = lane_bound(name, L_MAIN)
        log(f"[time] {name} L={L_MAIN}: kernel {ms[name]:.4f} ms events, "
            f"{dev_ms[name]:.4f} ms device; plain {plain_ms[name]:.4f} ms "
            f"events; bound {bounds[name][0]:.4f} ms ({bounds[name][1]}) "
            "(medians of 20)")
    for L in K2_LANES:
        q, qd, u = inputs(L, 90)
        call = lambda: lanes.fd_kernel(dyn.packed(q), 6, q, qd, u)
        t_ev, t_dev = events_ms(call), device_ms(call)
        bnd, by = lane_bound("fd", L)
        log(f"[time] fd L={L}: kernel {t_ev:.4f} ms events, {t_dev:.4f} ms "
            f"device; bound {bnd:.4f} ms ({by}), {100 * bnd / t_dev:.1f}% of "
            "bound in device time (medians of 20)")
    S, b = random_systems(torch, BT, B, N, PCG_BS, 91, 1.0, f32, dev)
    ops = FP.pack_operands(S, b, "SS")
    kw = dict(precond="SS", tol=0.0, max_iter=40, relative=False)
    plain_ms["pcg"] = events_ms(lambda: FP.pcg_fused_plain(*ops, **kw))
    ms["pcg"] = events_ms(lambda: FP.pcg_fused_kernel(*ops, **kw))
    dev_ms["pcg"] = device_ms(lambda: FP.pcg_fused_kernel(*ops, **kw))
    # at tol = 0 every scenario runs the 40 iterations: one scenario's count
    # is every scenario's
    pcg_ops = B * opcount.count_pcg(*(t[:1] for t in ops), ss=True,
                                    relative=False, max_iter=40, tol=0.0)
    pcg_bytes = 4 * (sum(t.numel() for t in ops) + ops[3].numel()) + 4 * B
    by_ops, by_bytes = pcg_ops / PEAK_FLOPS, pcg_bytes / PEAK_BYTES
    bounds["pcg"] = (1e3 * max(by_ops, by_bytes),
                     "operations" if by_ops >= by_bytes else "bytes")
    log(f"[time] pcg B={B} N={N} bs={PCG_BS} SS 40 iterations: kernel "
        f"{ms['pcg']:.4f} ms events, {dev_ms['pcg']:.4f} ms device; plain "
        f"{plain_ms['pcg']:.4f} ms events; bound {bounds['pcg'][0]:.4f} ms "
        f"({bounds['pcg'][1]}; {pcg_ops} operations, {pcg_bytes} bytes) "
        "(medians of 20)")

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

    insitu_pcg(torch, BT, FP, F, knot_params, X0, U0, x0s, goals, dev)

    # ---- 6. the main path
    launched = (lanes.fd_grad_kernel, lanes.fd_kernel, K.task_vec_kernel,
                FP.pcg_fused_kernel)
    by_lanes, restore = record_lane_counts(lanes, K)
    torch.cuda.synchronize()
    for k in launched:
        k.launches = 0
    t0 = time.perf_counter()
    plant, res = F.run_episode(x0s, goals, steps=STEPS, cold_steps=COLD_STEPS,
                               N=N)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    restore()
    counts = {"fd_grad": lanes.fd_grad_kernel.launches,
              "fd": lanes.fd_kernel.launches,
              "task_vec": K.task_vec_kernel.launches}
    assert FP.pcg_fused_kernel.launches == 0   # method S runs no PCG
    gate_ok, finite = report_loop(
        torch, F, plant, x0s, goals, res, wall, counts, "[main]",
        f"flagship, {COLD_STEPS} cold thomas + {STEPS - COLD_STEPS} cr")
    assert all(v > 0 for v in counts.values()), counts
    assert finite
    assert res.X_applied.shape == (B, 12, STEPS + 1)
    assert gate_ok
    episode_weighted(kernels, inputs, by_lanes, lane_bound, device_ms,
                     "[main]")

    # ---- 7. the PCG-SS closed loop through K4
    pcg_counts = pcg_episode(torch, F, lanes, K, FP, x0s, goals, launched)
    counts["pcg"] = pcg_counts["pcg"]
    k4 = pcg_counts["pcg"]
    log(f"[pcg] K4 episode-weighted device time: {k4} launches x "
        f"{dev_ms['pcg']:.4f} ms (40 fixed iterations, an upper bound on the "
        f"episode's) = {k4 * dev_ms['pcg']:.2f} ms; bound {k4} x "
        f"{bounds['pcg'][0]:.4f} ms = {k4 * bounds['pcg'][0]:.2f} ms; loss "
        f"{k4 * (dev_ms['pcg'] - bounds['pcg'][0]):.2f} ms")

    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"trajoptmpcreference_tpu_torch/kernels/csrc/{name}.cu",
         "replaces": REPLACES[name], "launches": counts[name],
         "max_abs_err": max_abs[name], "ms": ms[name],
         "device_ms": dev_ms[name],
         "plain_ms": plain_ms[name], "bound_ms": bounds[name][0],
         "bound_by": bounds[name][1], "library_ms": None}
        for name in REPLACES]}))
    log(gpu_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def record_lane_counts(lanes, K):
    """Count the lanes kernels' launches by (library, lane count) while the
    main path runs, through the one launch function their wrappers share;
    returns (counter, restore)."""
    seen = collections.Counter()
    original = lanes.launch

    def recording(lib_name, n, packed, out, q, qd, u=None):
        seen[(lib_name, q.shape[1])] += 1
        return original(lib_name, n, packed, out, q, qd, u)

    lanes.launch = K.launch = recording

    def restore():
        lanes.launch = K.launch = original

    return seen, restore


def episode_weighted(kernels, inputs, by_lanes, lane_bound, device_ms, tag):
    """Print each lanes kernel's launches by lane count, its episode-
    weighted device time and bound (the sums over lane counts of launches x
    the kernel's device time, median of 20 on random inputs, and of
    launches x its bound at that count) and the loss between them."""
    for name, (kern, _, _) in kernels.items():
        split = sorted((L, c) for (lib, L), c in by_lanes.items() if lib == name)
        total, bound, parts = 0.0, 0.0, []
        for L, c in split:
            q, qd, u = inputs(L, 95)
            t = device_ms(lambda: kern(q, qd, u))
            total += c * t
            bound += c * lane_bound(name, L)[0]
            parts.append(f"{c} x L={L} at {t:.4f} ms")
        log(f"{tag} {name} launches by lane count: " + ", ".join(parts)
            + f"; episode-weighted device time {total:.2f} ms, bound "
            f"{bound:.2f} ms, loss {total - bound:.2f} ms")


def random_systems(torch, BT, B, N, bs, seed, sign, dtype, dev):
    """B random block-tridiagonal systems, SPD (sign 1) or negative
    definite (sign -1), moderately conditioned (Jacobi-preconditioned CG
    needs ~30 iterations), and right-hand sides; drawn in f64 on the host."""
    g = torch.Generator().manual_seed(seed)
    rn = lambda *shape: torch.randn(*shape, generator=g, dtype=torch.float64)
    M = rn(B, N, bs, bs) / bs ** 0.5
    diag = M @ M.transpose(-1, -2) + torch.eye(bs, dtype=torch.float64)
    upper = 0.4 * rn(B, N - 1, bs, bs) / bs ** 0.5
    on = lambda t: t.to(dtype=dtype, device=dev)
    return BT.BlockTridiag(on(sign * diag), on(sign * upper)), on(rn(B, N, bs))


def check_pcg(torch, BT, FP, dev):
    """K4 against pcg_fused_plain on the card; returns max|d| of the
    B = 512 SS SPD fixed-iteration check."""
    f32, f64 = torch.float32, torch.float64
    fixed = dict(tol=0.0, max_iter=PCG_FIXED_ITERS, relative=False)
    conv = dict(tol=PCG_CONV_TOL, max_iter=PCG_CONV_ITERS, relative=True)
    max_abs = None
    for sign, kind in ((1.0, "spd"), (-1.0, "negdef")):
        for pre in ("J", "BJ", "SS"):
            S, b = random_systems(torch, BT, B, N, PCG_BS, 7, sign, f32, dev)
            ops = FP.pack_operands(S, b, pre)
            out, it = FP.pcg_fused_kernel(*ops, precond=pre, **fixed)
            ref, it_ref = FP.pcg_fused_plain(*ops, precond=pre, **fixed)
            torch.cuda.synchronize()
            assert bool(torch.isfinite(out).all()), (pre, kind)
            rel = rel_err(out, ref)
            if (pre, kind) == ("SS", "spd"):
                max_abs = float((out - ref).abs().max())
            x, it_c = FP.pcg_fused_kernel(*ops, precond=pre, **conv)
            x_cr = BT.btd_cyclic_reduction(S, b)
            per = ((x - x_cr).abs().amax((-1, -2))
                   / x_cr.abs().amax((-1, -2))).max().item()
            log(f"[check] pcg {pre} {kind} B={B} N={N}: {PCG_FIXED_ITERS} "
                f"iterations max|d|/max|ref| = {rel:.3e}; converged (rel "
                f"{PCG_CONV_TOL:.0e}, {int(it_c.min())}-{int(it_c.max())} "
                f"iterations) vs cyclic reduction, worst scenario "
                f"{per:.3e} (limit {PCG_TOL:.0e})")
            assert torch.equal(it, it_ref), (pre, kind)
            assert rel < PCG_TOL and per < PCG_TOL, (pre, kind, rel, per)
    for Bn, Nn in ((1, N), (1000, N), (B, N - 1)):
        for pre in ("J", "BJ", "SS"):
            S, b = random_systems(torch, BT, Bn, Nn, PCG_BS, Bn + Nn, 1.0,
                                  f32, dev)
            ops = FP.pack_operands(S, b, pre)
            out, _ = FP.pcg_fused_kernel(*ops, precond=pre, **fixed)
            ref, _ = FP.pcg_fused_plain(*ops, precond=pre, **fixed)
            rel = rel_err(out, ref)
            log(f"[check] pcg {pre} ragged B={Bn} N={Nn}: max|d|/max|ref| = "
                f"{rel:.3e} (limit {PCG_TOL:.0e})")
            assert rel < PCG_TOL, (pre, Bn, Nn, rel)
    # f64 (184 KB of shared memory per block) and the size limit
    S, b = random_systems(torch, BT, B, N, PCG_BS, 8, -1.0, f64, dev)
    ops = FP.pack_operands(S, b, "SS")
    out, _ = FP.pcg_fused_kernel(*ops, precond="SS", **fixed)
    ref, _ = FP.pcg_fused_plain(*ops, precond="SS", **fixed)
    rel = rel_err(out, ref)
    log(f"[check] pcg SS negdef f64 B={B} N={N}: max|d|/max|ref| = "
        f"{rel:.3e} (limit 1e-10)")
    assert rel < 1e-10, rel
    S, b = random_systems(torch, BT, 2, 4 * N, PCG_BS, 9, 1.0, f64, dev)
    try:
        FP.pcg_fused_kernel(*FP.pack_operands(S, b, "SS"), precond="SS",
                            **fixed)
    except ValueError as e:
        log(f"[check] pcg N={4 * N} f64 refused as it should be: {e}")
    else:
        raise AssertionError("K4 accepted a system over the shared-memory limit")
    return max_abs


def insitu_pcg(torch, BT, FP, F, knot_params, X0, U0, x0s, goals, dev):
    """K4 and its plain version on the flagship's cold-start Schur systems
    (the PCG-SS flagship's first QP at rho = 1e-3, relative exit 1e-4, 40
    iterations).  Those systems have condition ~1e7-1e9, so the check is
    on residuals, not elements."""
    _, cost, solver = F.flagship(N=N, dtype=torch.float32, device=dev,
                                 use_kernel_pcg=True, **F.PCG_KNOBS)
    kkt, o = solver.kkt, solver.options
    p = knot_params(cost.default_params._replace(xg=goals))
    blocks = kkt.form_blocks(X0, U0, x0s, p, ())
    S, gam, _, _ = kkt._schur_blocks_split(
        blocks, torch.full((B,), o.rho_init, dtype=torch.float32, device=dev))
    ops = FP.pack_operands(S, gam, "SS")
    kw = dict(precond="SS", tol=o.exit_tolerance_linSys,
              max_iter=o.max_iter_linSys, relative=o.pcg_relative)
    S64 = BT.BlockTridiag(S.diag.double(), S.upper.double())
    g64 = gam.double().flatten(1)
    stats = {}
    for name, fn in (("kernel", FP.pcg_fused_kernel),
                     ("plain", FP.pcg_fused_plain)):
        x, it = fn(*ops, **kw)
        res = (BT.btd_matvec(S64, x.double()).flatten(1) - g64)
        rel = res.norm(dim=1) / g64.norm(dim=1)
        stats[name] = (float(rel.median()), float(res.norm() / g64.norm()))
        hist = torch.bincount(it.long(), minlength=o.max_iter_linSys + 1)
        log(f"[in-situ] pcg {name}: |S x - gam|/|gam| per scenario median "
            f"{stats[name][0]:.3e} max {float(rel.max()):.3e}, whole batch "
            f"{stats[name][1]:.3e}; iteration counts "
            + json.dumps({i: int(c) for i, c in enumerate(hist.tolist()) if c}))
    # the per-scenario max is one chaotic system of 512; the median and the
    # whole batch are what the bar holds
    for i, what in enumerate(("median", "whole batch")):
        bound = 10 * max(stats["plain"][i], 1e-6)
        assert stats["kernel"][i] <= bound, (what, stats)


def pcg_episode(torch, F, lanes, K, FP, x0s, goals, launched):
    """The PCG-SS flagship closed loop through K1-K4 (phase 7)."""
    torch.cuda.synchronize()
    for k in launched:
        k.launches = 0
    t0 = time.perf_counter()
    plant, res = F.run_episode(x0s, goals, steps=STEPS, cold_steps=COLD_STEPS,
                               N=N, use_kernel_pcg=True, **F.PCG_KNOBS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"fd_grad": lanes.fd_grad_kernel.launches,
              "fd": lanes.fd_kernel.launches,
              "task_vec": K.task_vec_kernel.launches,
              "pcg": FP.pcg_fused_kernel.launches}
    gate_ok, finite = report_loop(torch, F, plant, x0s, goals, res, wall,
                                  counts, "[pcg]",
                                  f"PCG-SS flagship through K4, {COLD_STEPS} cold")
    if not gate_ok:
        # tell the kernel apart from the algorithm: the same loop on
        # btridiag.pcg (plain PyTorch, no K4)
        t0 = time.perf_counter()
        plant, res2 = F.run_episode(x0s, goals, steps=STEPS,
                                    cold_steps=COLD_STEPS, N=N,
                                    use_kernel_pcg=False, **F.PCG_KNOBS)
        torch.cuda.synchronize()
        report_loop(torch, F, plant, x0s, goals, res2,
                    time.perf_counter() - t0, {}, "[pcg]",
                    f"PCG-SS flagship through btridiag.pcg, {COLD_STEPS} cold")
    assert all(v > 0 for v in counts.values()), counts
    assert finite
    assert res.X_applied.shape == (B, 12, STEPS + 1)
    assert gate_ok
    return counts


def report_loop(torch, F, plant, x0s, goals, res, wall, counts, tag, label):
    """Print a closed loop's rate, launches and quality; returns (gate
    passed, states finite)."""
    err, dist0 = F.ee_errors(plant, x0s, goals, res)
    gate_ok, med_err, stable = F.quality_gate(err, dist0)
    finite = bool(torch.isfinite(res.X_applied).all()
                  and torch.isfinite(res.U_applied).all())
    log(f"{tag} {label}: B={B} N={N} {STEPS} steps, f32: wall {wall:.3f} s, "
        f"{B * STEPS / wall:.1f} solves/s, {1e3 * wall / STEPS:.2f} ms/step; "
        f"launches {json.dumps(counts)}; iters/step mean "
        f"{res.iters.float().mean().item():.3f}")
    log(f"{tag} quality ({label}): median EE err {med_err:.4f} m from "
        f"{float(np.median(dist0)):.2f} m, {stable}/{B} stable<1m, "
        f"states finite {finite}, gate {'passed' if gate_ok else 'FAILED'}")
    return gate_ok, finite


def ptxas_summary(report: str, key: str) -> str:
    """Registers / stack / spills of the entry functions whose mangled
    name holds ``key`` (e.g. the float, n = 6 lanes kernels)."""
    out, current = [], None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            current = key in line
        elif current and ("registers" in line or "spill" in line):
            out.append(" ".join(line.replace("ptxas info    :", "").split()))
    return "; ".join(out) or "no ptxas report"


if __name__ == "__main__":
    sys.exit(main())
