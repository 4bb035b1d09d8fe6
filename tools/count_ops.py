"""Count the operations PyTorch dispatches (views excluded) for the per-
sample dynamics and one steady flagship control step, on the CPU.

    python tools/count_ops.py [--B 2]

An eager PyTorch program on the card is bound by the operations it
launches, so the count of dispatched operations predicts how a change of
formulation moves a host-bound step.  Printed as JSON lines:

* one call of ``rbd.fd``, ``rbd.fd_grad`` and ``Kinematics.task_vec``
  (serial_arm(6), f32) beside the lanes plain versions they replace on
  the per-sample plant (``fd_lanes``, ``fd_grad_lanes``,
  ``LaneKinematics.task_vec_L``; on the card each of those is one kernel
  launch, K2, K1 or K3);
* one steady control step of the flagship (B scenarios, N = 64, f32,
  after the cold step), on the lanes plant and on the per-sample plant
  (``flagship.per_sample``): operations in all, the calls of each
  dynamics and kinematics function, and the lanes step's count with each
  call of a plain version counted as one launch, as on the card.

The counts do not depend on B (no loop runs over scenarios).
"""

from __future__ import annotations

import argparse
import collections
import json
import pathlib
import sys

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from trajoptmpcreference_tpu_torch import flagship as F  # noqa: E402
from trajoptmpcreference_tpu_torch.models.urdf import serial_arm  # noqa: E402
from trajoptmpcreference_tpu_torch.ops import kinematics as K  # noqa: E402
from trajoptmpcreference_tpu_torch.ops import lanes  # noqa: E402
from trajoptmpcreference_tpu_torch.ops.rbd import make_rbd  # noqa: E402


class OpCounter(TorchDispatchMode):
    """Counts every dispatched operation that is not a view."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            self.count += 1
        return func(*args, **(kwargs or {}))


def count(fn, *args):
    with OpCounter() as c:
        fn(*args)
    return c.count


class CallCounter:
    """Counts the calls of ``(owner, attribute)`` functions and the
    operations inside them while in the block; restores them on exit."""

    def __init__(self, targets):
        self.targets = targets
        self.calls = collections.Counter()
        self.inner_ops = collections.Counter()

    @staticmethod
    def _set(owner, name, fn):
        # a class takes setattr; an instance of a frozen dataclass (RBD)
        # object.__setattr__
        (setattr if isinstance(owner, type) else object.__setattr__)(
            owner, name, fn)

    def __enter__(self):
        self.saved = [(owner, name, getattr(owner, name))
                      for owner, name in self.targets]
        for owner, name, fn in self.saved:
            self._set(owner, name, self._wrap(name, fn))
        return self

    def _wrap(self, name, fn):
        def call(*args, **kwargs):
            self.calls[name] += 1
            with OpCounter() as c:
                out = fn(*args, **kwargs)
            self.inner_ops[name] += c.count
            return out
        return call

    def __exit__(self, *exc):
        for owner, name, fn in self.saved:
            self._set(owner, name, fn)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--B", type=int, default=2)
    args = ap.parse_args(argv)
    f32 = torch.float32
    robot = serial_arm(6)
    rbd = make_rbd(robot)
    kin = K.Kinematics(robot)
    lkin = K.LaneKinematics(robot)
    rng = np.random.default_rng(0)
    q, qd, u = (torch.as_tensor(0.3 * rng.standard_normal((63, 6)), dtype=f32)
                for _ in range(3))
    lq, lqd, lu = (a.T.contiguous() for a in (q, qd, u))
    C = lanes.lane_consts(robot, f32)
    count(rbd.fd, q, qd, u)                      # build the constant caches
    calls = {
        "rbd.fd": count(rbd.fd, q, qd, u),
        "rbd.fd_grad": count(rbd.fd_grad, q, qd, u),
        "Kinematics.task_vec": count(kin.task_vec, q, qd),
        "fd_lanes (plain K2)": count(
            lambda *a: lanes.fd_lanes(robot, *a, consts=C), lq, lqd, lu),
        "fd_grad_lanes (plain K1)": count(
            lambda *a: lanes.fd_grad_lanes(robot, *a, consts=C), lq, lqd, lu),
        "task_vec_L (plain K3)": count(lkin.task_vec_L, lq, lqd),
    }
    print(json.dumps({"operations per call (serial_arm(6), f32, CPU)": calls}))

    x0s, goals = (torch.as_tensor(a, dtype=f32) for a in F.bench_scenarios(args.B))
    for use_lanes in (True, False):
        plant, res = F.run_episode(x0s, goals, steps=1, cold_steps=1, N=64,
                                   device="cpu", use_lanes=use_lanes)
        _, cost, ctrl = F.flagship_mpc(N=64, dtype=f32, device="cpu")
        if not use_lanes:
            ctrl = F.per_sample(ctrl)
        params = cost.default_params._replace(xg=goals)
        step = lambda: ctrl.run(res.X_applied[..., -1], 1,
                                X_init=res.X_plan_last, U_init=res.U_plan_last,
                                cost_params=params, lam_init=res.lam_last)
        step()
        if use_lanes:
            targets = [(lanes.LaneDynamics, "fd"), (lanes.LaneDynamics, "fd_grad"),
                       (K.LaneKinematics, "task_vec")]
        else:
            rbd_obj = ctrl.plant.rbd
            targets = [(rbd_obj, "fd"), (rbd_obj, "fd_grad"),
                       (K.Kinematics, "task_vec")]
        with CallCounter(targets) as cc:
            total = count(step)
        line = {"step": "lanes plant" if use_lanes else "per-sample plant",
                "B": args.B, "operations": total, "calls": dict(cc.calls),
                "operations inside them": dict(cc.inner_ops)}
        if use_lanes:
            line["operations with each call one kernel launch"] = (
                total - sum(cc.inner_ops.values()) + sum(cc.calls.values()))
        print(json.dumps(line))


if __name__ == "__main__":
    main()
