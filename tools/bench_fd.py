"""Time K2 (fd.cu), K1 (fd_grad.cu), K3 (task_vec.cu) or K4 (pcg.cu)
against an older build of the same source, in one run.

    python tools/bench_fd.py --kernel fd|fd_grad|task_vec|pcg --baseline
        <dir with the older kernels/csrc: the .cu file and the headers it
        includes>

A development script: unpack the older tree with ``git archive`` into a
directory that ``.gitignore`` lists (``build/``) and point ``--baseline``
at its ``trajoptmpcreference_tpu_torch/kernels/csrc``.  Both builds are
held against the plain version (``fd_lanes``, ``fd_grad_lanes`` or
``LaneKinematics.task_vec_L``, serial_arm(6), f32 and f64) and timed in
turns (baseline, current, current, baseline), each turn with both timers
of kernels/timing.py:
``events_ms`` (CUDA events around one call, the kernels' ``ms`` in
chip_smoke.py) and ``device_ms`` (the same behind a device spin: device
time alone).  K2 runs at the flagship main path's lane counts (512,
32,256, 96,768, 290,304) and a ragged 1,000; K1 at its main-path 32,256
and 1,000; K3 at the main path's six (512, 1,536, 4,608, 32,256, 96,768,
290,304).  K4 solves B = 1, 512 and 1,000 random SS systems (N = 64,
bs = 12, 40 fixed iterations: the PCG-SS flagship's shape; another count
with ``--pcg-iters``), each build held against ``pcg_fused_plain``
(max|d|/max|ref|, equal iteration counts); its baseline must have
pcg.cu's entry with storage codes and a workspace (the layout since the
global-operator variant).  ``--pcg-shapes f32:128:12:512 ...`` (dtype, N,
bs, B) runs K4 at those shapes instead, each build taking the variant
its own ``variant()`` picks, and adds to each line both builds' variant,
the current build's cluster size and clusters resident at once
(cudaOccupancyMaxActiveClusters), chip_smoke.py's bound for the run's
iterations and, where the B operators exceed the H100's 50 MB L2, the
re-read floor (operator bytes x iterations / 3.35 TB/s).  One JSON line
per (dtype, L or B), with the device-time ratio
current / baseline (the means of each side's two turns), one line per
build with its ``ptxas -v`` summary, and one line with the time of an
empty launch (one block, built beside the baseline) by the same timers:
the floor under a small kernel's time.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from trajoptmpcreference_tpu_torch.kernels import _build  # noqa: E402
from trajoptmpcreference_tpu_torch.kernels.timing import (  # noqa: E402
    device_ms,
    events_ms,
)
from trajoptmpcreference_tpu_torch.models.urdf import serial_arm  # noqa: E402
from trajoptmpcreference_tpu_torch.ops import btridiag as BT  # noqa: E402
from trajoptmpcreference_tpu_torch.ops import fused_pcg as FP  # noqa: E402
from trajoptmpcreference_tpu_torch.ops import lanes  # noqa: E402
from trajoptmpcreference_tpu_torch.ops.kinematics import (  # noqa: E402
    LaneKinematics,
    task_vec_kernel,
)
from chip_smoke import (  # noqa: E402
    L2_BYTES,
    PEAK_BYTES,
    pcg_bound,
    ptxas_summary,
    random_systems,
)

LANE_COUNTS = {"fd": (512, 1000, 32_256, 96_768, 290_304),
               "fd_grad": (1000, 32_256),
               "task_vec": (512, 1536, 4608, 32_256, 96_768, 290_304)}
PCG_BATCHES, PCG_N, PCG_BS = (1, 512, 1000), 64, 12
# the entry functions whose ptxas lines are printed: n = 6, or bs = 12 (K4's
# first design had one kernel per type; then the register, shared, global
# and cluster variants; now the register variant and the cluster template
# (GOP, MULTI): a cluster (Lb0ELb1E), one block (Lb0ELb0E), the global
# operator (Lb1ELb1E))
PTXAS_KEYS = {"fd": ("IfLi6E", "IdLi6E"), "fd_grad": ("IfLi6E", "IdLi6E"),
              "task_vec": ("IfLi6E", "IdLi6E"),
              "pcg": ("pcg_kernelIfE", "pcg_kernelIdE", "pcg_regsIfLi12E",
                      "pcg_regsIdLi12E", "pcg_sharedIfE", "pcg_sharedIdE",
                      "pcg_globalIfE", "pcg_globalIdE",
                      "pcg_clusterIfLi12EE", "pcg_clusterIdLi12EE",
                      "pcg_clusterIfLi12ELb0ELb1E",
                      "pcg_clusterIdLi12ELb0ELb1E",
                      "pcg_clusterIfLi12ELb0ELb0E",
                      "pcg_clusterIdLi12ELb0ELb0E",
                      "pcg_clusterIfLi12ELb1ELb1E",
                      "pcg_clusterIdLi12ELb1ELb1E")}
PLAIN = {"fd": lanes.fd_lanes, "fd_grad": lanes.fd_grad_lanes,
         "task_vec": lambda robot, q, qd, u:
             LaneKinematics(robot).task_vec_L(q, qd)}
CURRENT = {"fd": lanes.fd_kernel, "fd_grad": lanes.fd_grad_kernel,
           "task_vec": lambda packed, n, q, qd, u:
               task_vec_kernel(packed, n, q, qd)}
# output rows per lane at n = 6
ROWS = {"fd": (6,), "fd_grad": (6, 18), "task_vec": (6,)}
_EMPTY = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int tmr_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
"""


def _build_baseline(kernel: str, src_dir: pathlib.Path) -> ctypes.CDLL:
    out = _build.BUILD_ROOT.parent / "bench_fd"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / f"lib{kernel}_baseline.so"
    done = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                           str(lib), str(src_dir / f"{kernel}.cu")],
                          capture_output=True, text=True, check=True)
    (out / f"{kernel}_baseline.ptxas.txt").write_text(done.stdout + done.stderr)
    base = ctypes.CDLL(str(lib))
    for sfx in ("f32", "f64"):
        getattr(base, f"tmr_{kernel}_{sfx}").argtypes = _build.ARGTYPES[kernel]
        getattr(base, f"tmr_{kernel}_{sfx}").restype = ctypes.c_int
    if kernel == "pcg":   # a pcg.cu with storage codes and a workspace
        _build.bind_pcg_shapes(base)
    return base


def _empty_launch() -> None:
    """Print the time of an empty kernel's launch (one block of 32
    threads) by both timers: the floor a small kernel's time sits on."""
    out = _build.BUILD_ROOT.parent / "bench_fd"
    src, lib = out / "empty.cu", out / "libempty.so"
    src.write_text(_EMPTY)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], capture_output=True, text=True, check=True)
    fn = ctypes.CDLL(str(lib)).tmr_empty
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int

    def call():
        if fn(torch.cuda.current_stream().cuda_stream) != 0:
            raise RuntimeError("the empty kernel failed to launch")

    print(json.dumps({"kernel": "empty", "grid": 1, "block": 32,
                      "events_ms": events_ms(call),
                      "device_ms": device_ms(call)}), flush=True)


def _turns(line, baseline, current):
    """Time both sides in turns (baseline, current, current, baseline)
    with both timers; add the device-time ratio to ``line``."""
    for turn, name in enumerate(("baseline", "current", "current",
                                 "baseline")):
        fn = baseline if name == "baseline" else current
        line[f"{name}_events_ms_{turn}"] = events_ms(fn)
        line[f"{name}_device_ms_{turn}"] = device_ms(fn)
    line["device_ratio"] = (
        (line["current_device_ms_1"] + line["current_device_ms_2"])
        / (line["baseline_device_ms_0"] + line["baseline_device_ms_3"]))
    print(json.dumps(line), flush=True)


def bench_pcg(base, iters: int, shapes=None) -> None:
    """K4: the baseline build against the current one with ``iters`` fixed
    SS iterations, f32 and f64 at B = PCG_BATCHES, N = 64, bs = 12, or at
    ``shapes`` ((dtype, N, bs, B), each build's own variant) with their
    bounds."""
    from trajoptmpcreference_tpu_torch.kernels import opcount
    dev = torch.device("cuda", 0)
    kw = dict(precond="SS", tol=0.0, max_iter=iters, relative=False)
    if shapes is None:
        shapes = [(dt, PCG_N, PCG_BS, B) for dt in (torch.float32,
                                                   torch.float64)
                  for B in PCG_BATCHES]
    else:
        opcount.build_all()
    lib = _build.library("pcg")
    for dt, N, bs, B in shapes:
        sfx = "f32" if dt == torch.float32 else "f64"
        fn_base = getattr(base, f"tmr_pcg_{sfx}")

        def baseline(*ops):
            return FP.launch(fn_base, *ops, work_elems=base.tmr_pcg_work_elems,
                             stream=torch.cuda.current_stream().cuda_stream,
                             **kw)

        def current(*ops):
            return FP.pcg_fused_kernel(*ops, **kw)

        S, b = random_systems(torch, BT, B, N, bs, 91, 1.0, dt, dev)
        ops = FP.pack_operands(S, b, "SS")
        del S, b
        ref, it_ref = FP.pcg_fused_plain(*ops, **kw)
        line = {"kernel": "pcg", "dtype": sfx, "B": B, "N": N, "bs": bs,
                "iters": iters}
        if (N, bs) != (PCG_N, PCG_BS):
            item = dt.itemsize
            line["baseline_variant"] = int(base.tmr_pcg_variant(N, bs, item))
            line["current_variant"] = FP.VARIANTS[FP.variant(N, bs, dt)]
            line["current_cluster"] = (FP.cluster_size(N, bs, dt)
                                       or min(N, 16))
            line["current_max_clusters"] = int(
                lib.tmr_pcg_max_clusters(N, bs, item))
            bnd, by, need, _, hist = pcg_bound(torch, opcount, FP, ops, kw)
            line.update(bound_ms=bnd, bound_by=by, needed_ops=need,
                        iterations=hist)
            op_bytes = B * N * (bs * (bs + 1) + bs * bs) * item
            if op_bytes > L2_BYTES:
                line["reread_floor_ms"] = (1e3 * op_bytes * iters
                                           / PEAK_BYTES)
        for name, fn in (("baseline", baseline), ("current", current)):
            out, it = fn(*ops)
            line[f"{name}_rel"] = float((out - ref).abs().max()
                                        / ref.abs().max())
            line[f"{name}_iters_equal"] = bool(torch.equal(it, it_ref))
        del ref
        _turns(line, lambda: baseline(*ops), lambda: current(*ops))
        if "bound_ms" in line:
            print(json.dumps({
                "kernel": "pcg", "dtype": sfx, "B": B, "N": N, "bs": bs,
                "share_of_bound": {
                    side: line["bound_ms"] / min(
                        line[f"{side}_device_ms_{t}"] for t in turns)
                    for side, turns in (("baseline", (0, 3)),
                                        ("current", (1, 2)))}}),
                flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=sorted(LANE_COUNTS) + ["pcg"],
                    default="fd")
    ap.add_argument("--baseline", type=pathlib.Path, required=True)
    ap.add_argument("--pcg-iters", type=int, default=40,
                    help="K4's fixed iterations (0: load, one "
                    "preconditioner application and store)")
    ap.add_argument("--pcg-shapes", nargs="*", default=None,
                    help="K4 at these shapes, dtype:N:bs:B (f32 or f64)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_fd: no CUDA device")
    kernel = args.kernel
    _build.build_all()
    base = _build_baseline(kernel, args.baseline)
    out = _build.BUILD_ROOT.parent / "bench_fd"
    for name, report in (
            ("baseline", (out / f"{kernel}_baseline.ptxas.txt").read_text()),
            ("current", _build.ptxas_report(kernel))):
        found = {key: ptxas_summary(report, key) for key in PTXAS_KEYS[kernel]}
        print(json.dumps({"kernel": kernel, "build": name, "ptxas": {
            k: v for k, v in found.items() if v != "no ptxas report"}}),
            flush=True)
    _empty_launch()
    if kernel == "pcg":
        shapes = None
        if args.pcg_shapes:
            dts = {"f32": torch.float32, "f64": torch.float64}
            shapes = [(dts[d], int(n), int(bs), int(b)) for d, n, bs, b in
                      (x.split(":") for x in args.pcg_shapes)]
        bench_pcg(base, args.pcg_iters, shapes)
        return 0
    robot = serial_arm(6)
    dev = torch.device("cuda", 0)
    for dt in (torch.float32, torch.float64):
        packed = lanes.pack_robot(robot, dt, dev)
        sfx = "f32" if dt == torch.float32 else "f64"
        fn_base = getattr(base, f"tmr_{kernel}_{sfx}")

        def baseline(q, qd, u):
            out = torch.empty(ROWS[kernel] + (q.shape[1],), dtype=q.dtype,
                              device=q.device)
            rc = fn_base(q.data_ptr(), qd.data_ptr(), u.data_ptr(),
                         packed.data_ptr(), out.data_ptr(), 6, q.shape[1],
                         torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"baseline {kernel} failed: cudaError {rc}")
            return out

        def current(q, qd, u):
            return CURRENT[kernel](packed, 6, q, qd, u)

        for L in LANE_COUNTS[kernel]:
            rng = np.random.default_rng(L)
            q, qd, u = (torch.as_tensor(0.3 * rng.standard_normal((6, L)),
                                        dtype=dt, device=dev) for _ in range(3))
            ref = PLAIN[kernel](robot, q, qd, u)
            line = {"kernel": kernel, "dtype": sfx, "L": L}
            for name, fn in (("baseline", baseline), ("current", current)):
                out = fn(q, qd, u)
                line[f"{name}_rel"] = float((out - ref).abs().max()
                                            / ref.abs().max())
            del ref
            _turns(line, lambda: baseline(q, qd, u), lambda: current(q, qd, u))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
