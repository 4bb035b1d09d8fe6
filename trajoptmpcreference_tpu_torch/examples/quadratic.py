"""Joint-space quadratic cost on a URDF arm with hard torque limits
(ref: examples/quadratic.py — despite the name it runs a URDF arm)."""

import numpy as np
import torch

from trajoptmpcreference_tpu_torch import (
    ConstraintSet,
    QuadraticCost,
    URDFPlant,
    serial_arm,
)
from trajoptmpcreference_tpu_torch.examples import helpers

N, dt = 10, 0.1
METHODS = ["N", "S"]


def config(device="cuda", dtype=torch.float64):
    """(plant, cost, constraints) of the example."""
    t = helpers.tensors(device, dtype)
    plant = URDFPlant(robot=serial_arm(2))
    Q = torch.diag(t([1.0, 1.0, 0.1, 0.1]))
    QF = torch.diag(t([100.0] * 4))
    R = 0.1 * torch.eye(2, dtype=dtype, device=device)
    xg = t([np.pi / 4, -np.pi / 3, 0.0, 0.0])   # joint-space goal
    cost = QuadraticCost(Q, QF, R, xg)
    constraints = ConstraintSet(2, 2, 2, N).with_torque_limits(
        7.0, -7.0, "ACTIVE_SET")
    return plant, cost, constraints


def run(device="cuda", dtype=torch.float64, methods=METHODS, **kw):
    return helpers.runSQPExample(*config(device, dtype), N, dt, methods, **kw)


def main(argv=None):
    run(**helpers.setting(helpers.parser(__doc__).parse_args(argv)))


if __name__ == "__main__":
    main()
