"""Flagship closed-loop MPC: 6-DoF arm, horizon 64, warm-started SQP-PCG
(BASELINE.json config 4: 'full MPC loop, horizon 64, warm-started SQP-PCG
at control rate').

Optional flags showcase the production features:
  --torque-limit L   box-limit |u| <= L via hard ACTIVE_SET rows (the
                     condensed Schur path)
  --watchdog W       closed-loop plan watchdog: coast + cold-reset the
                     warm carry when a solve goes bad (hard actuation
                     envelope)
"""

import dataclasses

import numpy as np
import torch

from trajoptmpcreference_tpu_torch import (
    ConstraintSet,
    SQPOptions,
    URDFPlant,
    UrdfCost,
    make_mpc,
    serial_arm,
)
from trajoptmpcreference_tpu_torch.examples import helpers
from trajoptmpcreference_tpu_torch.utils.timing import time_fn

N, dt = 64, 0.015
steps = 100
GOAL = (3.0, 2.0)


def config(N=N, torque_limit=0.0, watchdog=float("inf"), device="cuda",
           dtype=torch.float64):
    """(plant, controller, x0 (1, 12)) of the example."""
    t = helpers.tensors(device, dtype)
    plant = URDFPlant(robot=serial_arm(6))
    cost = UrdfCost(plant, torch.diag(t([1.0, 1.0, 1.0, 0.1, 0.1, 0.1])),
                    100.0 * torch.eye(6, dtype=dtype, device=device),
                    0.01 * torch.eye(6, dtype=dtype, device=device),
                    t([*GOAL, 0.0, 0.0, 0.0, 0.0]))
    options = SQPOptions(expected_reduction_min=-100.0, exit_tolerance=1e-4,
                         exit_tolerance_linSys=1e-4, max_iter=5,
                         max_iter_linSys=40)
    cset = None
    if torque_limit > 0:
        cset = ConstraintSet(6, 6, 6, N).with_torque_limits(
            torque_limit, -torque_limit, "ACTIVE_SET", activation_band=0.2)
    ctrl = make_mpc(plant, cost, cset, N, dt, method="QP-PCG-SS",
                    options=options)
    if watchdog != float("inf"):
        ctrl = dataclasses.replace(ctrl, watchdog_u_max=watchdog)
    x0 = t(0.1 * np.random.default_rng(0).standard_normal(12))[None]
    return plant, ctrl, x0


def run(N=N, steps=steps, torque_limit=0.0, watchdog=float("inf"),
        device="cuda", dtype=torch.float64, verbose=True, warmup=1):
    """One timed closed loop after ``warmup`` untimed ones (the JAX
    script's compile call); returns dict(ee_err, max_abs_u, wall, res) and
    prints the JAX script's lines."""
    plant, ctrl, x0 = config(N, torque_limit, watchdog, device, dtype)
    wall, res = time_fn(lambda x: ctrl.run(x, steps=steps), x0, reps=1,
                        warmup=warmup)
    ee = plant.kinematics.ee_pos_x(res.X_applied[:, :, -1])[0]
    err = float(torch.linalg.norm(ee - torch.tensor(GOAL, dtype=ee.dtype,
                                                    device=ee.device)))
    umax = float(res.U_applied.abs().max())
    if verbose:
        print(f"{steps} MPC steps in {wall:.3f}s  ({steps / wall:.1f} Hz "
              f"control rate)")
        print(f"final EE {ee.cpu().numpy().round(4)}  goal [3. 2.]  "
              f"err {err:.4f} m")
        if torque_limit > 0:
            print(f"max |u| applied {umax:.3f} (limit {torque_limit:g})")
    return dict(ee_err=err, max_abs_u=umax, wall=wall, res=res)


def main(argv=None):
    ap = helpers.parser(__doc__)
    ap.add_argument("--torque-limit", type=float, default=0.0)
    ap.add_argument("--watchdog", type=float, default=float("inf"))
    args = ap.parse_args(argv)
    run(torque_limit=args.torque_limit, watchdog=args.watchdog,
        **helpers.setting(args))


if __name__ == "__main__":
    main()
