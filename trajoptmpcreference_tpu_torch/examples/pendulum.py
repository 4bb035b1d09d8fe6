"""Pendulum swing-up: iLQR + SQP MPC with torque limits.

The JAX package's restoration of the reference's broken example (ref:
examples/pendulum.py — it calls PendulumPlant and runMPCExample which the
snapshot dropped) with the same configuration: N=20, dt=0.1, goal
[pi, 0], torque limit +-7 as hard active-set (SQP) / soft AL (both).
"""

import numpy as np
import torch

from trajoptmpcreference_tpu_torch import (
    ConstraintSet,
    PendulumPlant,
    QuadraticCost,
    SQPOptions,
)
from trajoptmpcreference_tpu_torch.examples import helpers

N, dt = 20, 0.1
MPC_STEPS = 40


def config(device="cuda", dtype=torch.float64):
    """dict(plant, cost, soft, hard, hard_opts) of the example."""
    t = helpers.tensors(device, dtype)
    plant = PendulumPlant()
    Q = torch.diag(t([1.0, 1.0]))
    QF = torch.diag(t([100.0, 100.0]))
    R = 0.1 * torch.eye(1, dtype=dtype, device=device)
    xg = t([np.pi, 0.0])
    cost = QuadraticCost(Q, QF, R, xg)
    # soft AL torque limits (ref: examples/pendulum.py:22-25)
    soft = ConstraintSet(1, 1, 1, N).with_torque_limits(
        [7.0], [-7.0], "AUGMENTED_LAGRANGIAN")
    # hard active-set limits with the chatter-damping knobs (see
    # solvers/constraints.py BoxLimitSpec.activation_band and
    # SQPOptions.hard_violation_exit_tol): reference-parity defaults can
    # exit 'converged' mid-oscillation with the bound still violated
    hard = ConstraintSet(1, 1, 1, N).with_torque_limits(
        [7.0], [-7.0], "ACTIVE_SET", activation_band=0.2)
    hard_opts = SQPOptions(expected_reduction_min=-100.0, max_iter=40,
                           hard_violation_exit_tol=1e-3)
    return dict(plant=plant, cost=cost, soft=soft, hard=hard,
                hard_opts=hard_opts)


def run(device="cuda", dtype=torch.float64, steps=MPC_STEPS, **kw):
    """The example's three blocks; returns their results by name."""
    c = config(device, dtype)
    plant, cost = c["plant"], c["cost"]
    print("== single solves, soft AL torque limits ==")
    soft = helpers.runSQPExample(plant, cost, c["soft"], N, dt,
                                 ["N", "S", "PCG-SS"], **kw)
    print("== single solves, hard ACTIVE_SET torque limits ==")
    hard = helpers.runSQPExample(plant, cost, c["hard"], N, dt,
                                 ["S", "PCG-SS"], options=c["hard_opts"], **kw)
    print(f"== closed-loop MPC ({steps} steps) ==")
    mpc = helpers.runMPCExample(plant, cost, c["soft"], N, dt,
                                ["iLQR", "QP-S"], steps=steps, **kw)
    return dict(soft=soft, hard=hard, mpc=mpc)


def main(argv=None):
    run(**helpers.setting(helpers.parser(__doc__).parse_args(argv)))


if __name__ == "__main__":
    main()
