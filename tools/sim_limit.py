"""What the simulated arm's joint velocity limit changes in the flagship's
closed loops, on one CUDA card.

    python tools/sim_limit.py

A development script.  It runs the flagship loop (B = 512, N = 64, 150
steps, f32; bench.py's scenarios) with ``flagship.SIM_QD_MAX`` and again
without a limit, for method S, for PCG-SS through K4, and for PCG-SS with
K1's plain version ``fd_grad_lanes`` in place of K1 (K2-K4 stay kernels).
Per loop it prints one JSON line: the scenarios whose states are
non-finite, the scenarios held at the limit, the scenarios that differ
between the two runs and each one's largest |qd| without the limit, and
the quality gate's numbers.  For each scenario that differs, one more line
traces the run without the limit from 10 steps before the first
difference: per step the largest |u0| applied, the largest |qd| reached
and the solve's exit code.
"""

from __future__ import annotations

import json
import math
import pathlib
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from trajoptmpcreference_tpu_torch import flagship as F  # noqa: E402
from trajoptmpcreference_tpu_torch.ops import lanes  # noqa: E402

B, N, STEPS = 512, 64, 150


def ids(mask):
    return torch.nonzero(mask).flatten().tolist()


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("sim_limit: no CUDA device")
    dev = torch.device("cuda", 0)
    x0n, gn = F.bench_scenarios(B)
    x0s = torch.as_tensor(x0n, dtype=torch.float32, device=dev)
    goals = torch.as_tensor(gn, dtype=torch.float32, device=dev)

    def episode(pcg, limit):
        knobs = dict(F.PCG_KNOBS, use_kernel_pcg=True) if pcg else {}
        plant, res = F.run_episode(x0s, goals, steps=STEPS, N=N,
                                   sim_qd_max=limit, **knobs)
        torch.cuda.synchronize()
        return plant, res

    def compare(label, pcg):
        plant, on = episode(pcg, F.SIM_QD_MAX)
        _, off = episode(pcg, math.inf)
        qd_on = on.X_applied[:, 6:].abs().amax((1, 2))
        qd_off = off.X_applied[:, 6:].abs().nan_to_num(nan=math.inf).amax((1, 2))
        changed = (on.X_applied != off.X_applied).any(2).any(1)
        err, dist0 = F.ee_errors(plant, x0s, goals, on)
        gate, med, stable = F.quality_gate(err, dist0)
        print(json.dumps(dict(
            loop=label, limit=F.SIM_QD_MAX,
            nonfinite_on=ids(~torch.isfinite(on.X_applied).all(2).all(1)),
            nonfinite_off=ids(~torch.isfinite(off.X_applied).all(2).all(1)),
            controls_finite_on=bool(torch.isfinite(on.U_applied).all()),
            at_limit=ids(qd_on >= F.SIM_QD_MAX), changed=ids(changed),
            changed_qd_max_off=[float(qd_off[b]) for b in ids(changed)],
            unchanged_qd_max=(float(qd_on[~changed].max())
                              if (~changed).any() else None),
            median_err_m=med, stable=stable, gate=gate)), flush=True)
        for b in ids(changed):
            k0 = max(int(ids((on.X_applied[b] != off.X_applied[b]).any(0))[0])
                     - 10, 0)
            trace = [(k, float(off.U_applied[b, :, k].abs().max()),
                      float(off.X_applied[b, 6:, k + 1].abs().max()),
                      int(off.exit_codes[b, k])) for k in range(k0, STEPS)]
            print(json.dumps(dict(loop=label, scenario=b, off_trace=[
                "step %d: |u0| %.4g, |qd| %.4g, exit %d" % t for t in trace])),
                flush=True)

    compare("S", pcg=False)
    compare("PCG-SS", pcg=True)
    lanes.LaneDynamics.fd_grad = lambda self, q, qd, u: lanes.fd_grad_lanes(
        self.robot, q, qd, u, self.gravity, self.consts(q))
    compare("PCG-SS, K1's plain version", pcg=True)
    print(torch.cuda.get_device_name(0), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
