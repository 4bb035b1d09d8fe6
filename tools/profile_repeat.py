"""Profile one steady flagship control step several times in one fresh
process, after different warm-ups, and print each profile's device
operations and, by name, how each differs from the first.

    python tools/profile_repeat.py        # on a machine with a CUDA card

The step continues a 6-step episode (B = 512, N = 64, f32, kernels on),
as chip_smoke.py's phase 6 profiles it.  Warm-ups: a plain call ("plain"),
a call under FlopCounterMode ("flop", what utils.cost_analysis does), or
none.  It tells a change of the step's device work from a change of what
torch.profiler captures.
"""

import collections
import json
import pathlib
import sys

import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils.flop_counter import FlopCounterMode

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from trajoptmpcreference_tpu_torch import flagship as F  # noqa: E402
from trajoptmpcreference_tpu_torch.kernels import _build  # noqa: E402

B, N = 512, 64
WARMUPS = ["plain", "plain", "flop", "flop", "none", "plain", "flop"]


def main():
    if not torch.cuda.is_available():
        print("profile_repeat: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    dev = torch.device("cuda", 0)
    x0s_np, goals_np = F.bench_scenarios(B)
    x0s = torch.as_tensor(x0s_np, dtype=torch.float32, device=dev)
    goals = torch.as_tensor(goals_np, dtype=torch.float32, device=dev)
    _, res = F.run_episode(x0s, goals, steps=6, cold_steps=1, N=N)
    _, cost, ctrl = F.flagship_mpc(N=N, dtype=torch.float32, device=dev)
    params = cost.default_params._replace(xg=goals)
    step = lambda: ctrl.run(res.X_applied[..., -1], 1, X_init=res.X_plan_last,
                            U_init=res.U_plan_last, cost_params=params,
                            cstate_init=res.cstate_last, lam_init=res.lam_last)

    def profiled(warm):
        if warm == "plain":
            step()
        elif warm == "flop":
            with FlopCounterMode(display=False):
                step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = step()
            torch.cuda.synchronize()
        names = collections.Counter(
            e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA)
        return names, int(out.iters.sum())

    runs = [(warm, *profiled(warm)) for warm in WARMUPS]
    first = runs[0][1]
    for warm, names, iters in runs:
        moved = {k: names[k] - first[k] for k in set(names) | set(first)
                 if names[k] != first[k]}
        print(json.dumps({"warm-up": warm, "device operations":
                          sum(names.values()), "SQP iterations": iters,
                          "by name, minus the first profile": moved}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
