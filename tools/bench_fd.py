"""Time K2 (kernels/csrc/fd.cu) against an older build of fd.cu, in one run.

    python tools/bench_fd.py --baseline <dir with an older fd.cu and the
                                         lanes_common.cuh it includes>

A development script: unpack the older tree with ``git archive`` into a
directory that ``.gitignore`` lists (``build/``) and point ``--baseline``
at its ``kernels/csrc``.  Both builds are held against the plain version
``fd_lanes`` (serial_arm(6), f32 and f64) and timed in turns (baseline,
current, current, baseline) at the flagship main path's lane counts (512,
32,256, 96,768, 290,304) and a ragged 1,000, each turn with both timers of
kernels/timing.py: ``events_ms`` (CUDA events around one call, the
kernels' ``ms`` in chip_smoke.py) and ``device_ms`` (the same behind a
device spin: device time alone).  One JSON line per (dtype, L).
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

LANE_COUNTS = (512, 1000, 32_256, 96_768, 290_304)


def _build_baseline(src_dir: pathlib.Path) -> ctypes.CDLL:
    out = _build.BUILD_ROOT.parent / "bench_fd"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libfd_baseline.so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(src_dir / "fd.cu")], capture_output=True, text=True,
                   check=True)
    base = ctypes.CDLL(str(lib))
    for sfx in ("f32", "f64"):
        getattr(base, f"tmr_fd_{sfx}").argtypes = _build.ARGTYPES["fd"]
        getattr(base, f"tmr_fd_{sfx}").restype = ctypes.c_int
    return base


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=pathlib.Path, required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_fd: no CUDA device")
    _build.build_all()
    base = _build_baseline(args.baseline)
    robot = serial_arm(6)
    dev = torch.device("cuda", 0)
    for dt in (torch.float32, torch.float64):
        packed = lanes.pack_robot(robot, dt, dev)
        fn_base = getattr(base, "tmr_fd_f32" if dt == torch.float32 else "tmr_fd_f64")

        def baseline(q, qd, u):
            out = torch.empty_like(q)
            rc = fn_base(q.data_ptr(), qd.data_ptr(), u.data_ptr(),
                         packed.data_ptr(), out.data_ptr(), 6, q.shape[1],
                         torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"baseline fd failed: cudaError {rc}")
            return out

        def current(q, qd, u):
            return lanes.fd_kernel(packed, 6, q, qd, u)

        for L in LANE_COUNTS:
            rng = np.random.default_rng(L)
            q, qd, u = (torch.as_tensor(0.3 * rng.standard_normal((6, L)),
                                        dtype=dt, device=dev) for _ in range(3))
            ref = lanes.fd_lanes(robot, q, qd, u)
            line = {"dtype": str(dt).replace("torch.", ""), "L": L}
            for name, fn in (("baseline", baseline), ("current", current)):
                out = fn(q, qd, u)
                line[f"{name}_rel"] = float((out - ref).abs().max()
                                            / ref.abs().max())
            for turn, name in enumerate(("baseline", "current", "current",
                                         "baseline")):
                fn = baseline if name == "baseline" else current
                line[f"{name}_events_ms_{turn}"] = events_ms(lambda: fn(q, qd, u))
                line[f"{name}_device_ms_{turn}"] = device_ms(lambda: fn(q, qd, u))
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
