"""Run chip_smoke.py's phases 23-25 alone on the card, after building the
kernels, to iterate on them without phases 1-22 (~6 minutes).

    python tools/chip_phases.py [23] [24] [25]      # on a machine with a CUDA card

23: K4's storage dtypes; 24: K4's cluster and global-operator variants
(checked, and timed in turn), the generic operator and the long-horizon
solve; 25: the examples.  A development script: the
phases' bars and prints are chip_smoke.py's own.
"""

import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as C  # noqa: E402
from trajoptmpcreference_tpu_torch import flagship as F  # noqa: E402
from trajoptmpcreference_tpu_torch.kernels import _build, opcount  # noqa: E402
from trajoptmpcreference_tpu_torch.kernels.timing import device_ms, events_ms  # noqa: E402
from trajoptmpcreference_tpu_torch.ops import btridiag as BT  # noqa: E402
from trajoptmpcreference_tpu_torch.ops import fused_pcg as FP  # noqa: E402
from trajoptmpcreference_tpu_torch.solvers.sqp import knot_params  # noqa: E402


def main(argv=None) -> int:
    phases = (argv if argv is not None else sys.argv[1:]) or ["23", "24", "25"]
    if not torch.cuda.is_available():
        print("chip_phases: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all()
    opcount.build_all()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda", 0)
    x0s_np, goals_np = F.bench_scenarios(C.B)
    x0s = torch.as_tensor(x0s_np, dtype=torch.float32, device=dev)
    goals = torch.as_tensor(goals_np, dtype=torch.float32, device=dev)
    X0 = x0s[..., None].expand(C.B, 12, C.N).contiguous()
    U0 = torch.zeros((C.B, 6, C.N - 1), dtype=torch.float32, device=dev)
    run = {
        "23": lambda: C.storage_dtypes(torch, BT, FP, F, knot_params, X0, U0,
                                       x0s, goals, dev),
        "24": lambda: C.beyond_shared(torch, BT, FP, F, opcount, knot_params,
                                      events_ms, device_ms, x0s_np, goals_np,
                                      dev),
        "25": lambda: C.examples_on_card(torch, dev),
    }
    for phase in phases:
        t = time.perf_counter()
        run[phase]()
        print(f"phase {phase}: {time.perf_counter() - t:.1f} s", flush=True)
    print(C.gpu_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
