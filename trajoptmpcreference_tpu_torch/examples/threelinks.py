"""3-link arm variant (ref: examples/threelinks.py)."""

import torch

from trajoptmpcreference_tpu_torch import (
    SQPOptions,
    URDFPlant,
    UrdfCost,
    serial_arm,
)
from trajoptmpcreference_tpu_torch.examples import helpers

N, dt = 10, 0.1
METHODS = ["S", "PCG-SS"]


def config(device="cuda", dtype=torch.float64):
    """(plant, cost, options) of the example."""
    t = helpers.tensors(device, dtype)
    plant = URDFPlant(robot=serial_arm(3))
    Q = torch.diag(t([1.0] * 3 + [1.0] * 3))
    QF = torch.diag(t([100.0] * 6))
    R = 0.1 * torch.eye(3, dtype=dtype, device=device)
    xg = t([1.0, 2.0, 0.0, 0.0, 0.0, 0.0])   # [ee xyz, ee vel xyz]
    cost = UrdfCost(plant, Q, QF, R, xg)
    # merit_mu=100: the reference's fixed mu=10 under-weights feasibility
    # at this cost scale and the solver stalls at viol ~ 2.7 (see sqp.py
    # SQPOptions.merit_mu notes); 100 converges to viol ~ 0.3
    options = SQPOptions(expected_reduction_min=-100.0, merit_mu=100.0)
    return plant, cost, options


def run(device="cuda", dtype=torch.float64, methods=METHODS, **kw):
    plant, cost, options = config(device, dtype)
    return helpers.runSQPExample(plant, cost, None, N, dt, methods,
                                 options=options, **kw)


def main(argv=None):
    run(**helpers.setting(helpers.parser(__doc__).parse_args(argv)))


if __name__ == "__main__":
    main()
