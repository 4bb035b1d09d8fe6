"""Cross-check the three 2-link cost implementations at a point
(ref: examples/compare_cost.py:39-64): UrdfCost (general kinematics),
ArmCost (closed-form 2-link), NumericalCost (finite differences)."""

import numpy as np
import torch

from trajoptmpcreference_tpu_torch import (
    ArmCost,
    NumericalCost,
    URDFPlant,
    UrdfCost,
    serial_arm,
)
from trajoptmpcreference_tpu_torch.examples import helpers

X = [0.3, -0.7, 0.2, -0.1]
U = [0.5, -0.4]
K = 3


def config(device="cuda", dtype=torch.float64):
    """{name: cost} of the three implementations, and the point (x, u, k),
    each a batch of one."""
    t = helpers.tensors(device, dtype)
    plant = URDFPlant(robot=serial_arm(2))
    Q = torch.diag(t([1.0, 1.0, 1.0, 1.0]))
    QF = torch.diag(t([100.0] * 4))
    R = 0.1 * torch.eye(2, dtype=dtype, device=device)
    xg = t([0.5, 1.5, 0.0, 0.0])
    costs = {"urdf": UrdfCost(plant, Q, QF, R, xg),
             "arm": ArmCost(Q, QF, R, xg),
             "numerical": NumericalCost(plant, Q, QF, R, xg)}
    k = torch.tensor([K], device=device)
    return costs, (t(X)[None], t(U)[None], k)


def run(device="cuda", dtype=torch.float64, verbose=True):
    """{name: (stage value, stage gradient)} as float / numpy, printed as
    the JAX script prints them."""
    costs, (x, u, k) = config(device, dtype)
    out = {}
    for name, c in costs.items():
        p = c.default_params
        v = float(c.stage_value(p, x, u, k)[0])
        g = c.stage_gradient(p, x, u, k)[0].cpu().numpy()
        out[name] = (v, g)
        if verbose:
            print(f"{name:10s} value {v:.8f}  grad {g.round(6)}")
    if verbose:
        print("max|urdf-arm|      =",
              np.abs(out["urdf"][1] - out["arm"][1]).max())
        print("max|urdf-numerical|=",
              np.abs(out["urdf"][1] - out["numerical"][1]).max())
    return out


def main(argv=None):
    run(**helpers.setting(helpers.parser(__doc__).parse_args(argv)))


if __name__ == "__main__":
    main()
