"""2-link arm task-space reach — the reference's main working driver
(ref: examples/twolinks.py): arm2, UrdfCost, N=10, dt=0.1, every SQP
method, optional torque limits (hard active-set or soft AL)."""

import torch

from trajoptmpcreference_tpu_torch import (
    ConstraintSet,
    SQPOptions,
    URDFPlant,
    UrdfCost,
    serial_arm,
)
from trajoptmpcreference_tpu_torch.examples import helpers

N, dt = 10, 0.1
set_hard_constraints = False
set_soft_constraints = False
METHODS = ["N", "S", "PCG-J", "PCG-BJ", "PCG-SS"]


def config(device="cuda", dtype=torch.float64):
    """(plant, cost, constraints, options) of the example."""
    t = helpers.tensors(device, dtype)
    plant = URDFPlant(robot=serial_arm(2))
    Q = torch.diag(t([1.0, 1.0, 1.0, 1.0]))
    QF = torch.diag(t([100.0] * 4))
    R = 0.1 * torch.eye(2, dtype=dtype, device=device)
    xg = t([0.5, 1.5, 0.0, 0.0])        # [ee_x, ee_y, ee_vx, ee_vy]
    cost = UrdfCost(plant, Q, QF, R, xg)
    constraints = None
    if set_hard_constraints:
        constraints = ConstraintSet(2, 2, 2, N).with_torque_limits(
            7.0, -7.0, "ACTIVE_SET")
    elif set_soft_constraints:
        constraints = ConstraintSet(2, 2, 2, N).with_torque_limits(
            7.0, -7.0, "AUGMENTED_LAGRANGIAN")
    # ref: examples/twolinks.py:87 disables the lower reduction-ratio check
    options = SQPOptions(expected_reduction_min=-100.0)
    return plant, cost, constraints, options


def run(device="cuda", dtype=torch.float64, methods=METHODS, **kw):
    plant, cost, constraints, options = config(device, dtype)
    return helpers.runSQPExample(plant, cost, constraints, N, dt, methods,
                                 options=options, **kw)


def main(argv=None):
    run(**helpers.setting(helpers.parser(__doc__).parse_args(argv)))


if __name__ == "__main__":
    main()
