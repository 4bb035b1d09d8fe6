"""Time K2 (fd.cu) or K1 (fd_grad.cu) against an older build of the same
source, in one run.

    python tools/bench_fd.py --kernel fd|fd_grad --baseline <dir with the
        older kernels/csrc: the .cu file and the headers it includes>

A development script: unpack the older tree with ``git archive`` into a
directory that ``.gitignore`` lists (``build/``) and point ``--baseline``
at its ``trajoptmpcreference_tpu_torch/kernels/csrc``.  Both builds are
held against the plain version (``fd_lanes`` or ``fd_grad_lanes``,
serial_arm(6), f32 and f64) and timed in turns (baseline, current,
current, baseline), each turn with both timers of kernels/timing.py:
``events_ms`` (CUDA events around one call, the kernels' ``ms`` in
chip_smoke.py) and ``device_ms`` (the same behind a device spin: device
time alone).  K2 runs at the flagship main path's lane counts (512,
32,256, 96,768, 290,304) and a ragged 1,000; K1 at its main-path 32,256
and 1,000.  One JSON line per (dtype, L), with the device-time ratio
current / baseline (the means of each side's two turns).
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
from trajoptmpcreference_tpu_torch.ops import lanes  # noqa: E402

LANE_COUNTS = {"fd": (512, 1000, 32_256, 96_768, 290_304),
               "fd_grad": (1000, 32_256)}
PLAIN = {"fd": lanes.fd_lanes, "fd_grad": lanes.fd_grad_lanes}
CURRENT = {"fd": lanes.fd_kernel, "fd_grad": lanes.fd_grad_kernel}


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
    return base


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=sorted(LANE_COUNTS), default="fd")
    ap.add_argument("--baseline", type=pathlib.Path, required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_fd: no CUDA device")
    kernel = args.kernel
    _build.build_all()
    base = _build_baseline(kernel, args.baseline)
    robot = serial_arm(6)
    dev = torch.device("cuda", 0)
    for dt in (torch.float32, torch.float64):
        packed = lanes.pack_robot(robot, dt, dev)
        sfx = "f32" if dt == torch.float32 else "f64"
        fn_base = getattr(base, f"tmr_{kernel}_{sfx}")
        rows = 3 * 6 if kernel == "fd_grad" else None

        def baseline(q, qd, u):
            shape = (6, rows, q.shape[1]) if rows else q.shape
            out = torch.empty(shape, dtype=q.dtype, device=q.device)
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
            for turn, name in enumerate(("baseline", "current", "current",
                                         "baseline")):
                fn = baseline if name == "baseline" else current
                line[f"{name}_events_ms_{turn}"] = events_ms(lambda: fn(q, qd, u))
                line[f"{name}_device_ms_{turn}"] = device_ms(lambda: fn(q, qd, u))
            line["device_ratio"] = (
                (line["current_device_ms_1"] + line["current_device_ms_2"])
                / (line["baseline_device_ms_0"] + line["baseline_device_ms_3"]))
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
