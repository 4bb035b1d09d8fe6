"""Plant layer: URDF dynamics + integrator as batched functions.

Port of ``URDFPlant`` from trajoptmpcreference_tpu/models/plants.py
(ref: TrajoptPlant.py:274-332).  The analytic plants (double integrator,
pendulum, cart-pole) are still to be ported (ROADMAP queue 1).

Every function takes x (..., nx) and u (..., nu) with any leading batch
dimensions; they are flattened onto the lane axis of the dynamics
(ops/lanes.LaneDynamics), so one call over a whole (scenario x knot) batch
is one kernel launch on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from trajoptmpcreference_tpu_torch.models.robot import RobotModel
from trajoptmpcreference_tpu_torch.models.urdf import parse_urdf
from trajoptmpcreference_tpu_torch.ops.integrators import make_integrator
from trajoptmpcreference_tpu_torch.ops.kinematics import LaneKinematics
from trajoptmpcreference_tpu_torch.ops.lanes import LaneDynamics


@dataclasses.dataclass(frozen=True)
class Plant:
    """Sizes, state derivative, its Jacobian, and the integrator.

    step(x, u, dt) -> x_{k+1};  step_gradient(x, u, dt) -> (A, B)
    """

    name: str
    nq: int
    nv: int
    nu: int
    integrator_type: int
    xdot: Callable
    dxdot: Callable
    step: Callable
    step_gradient: Callable
    dynamics: Optional[LaneDynamics] = None
    kinematics: Optional[LaneKinematics] = None
    robot: Optional[RobotModel] = None

    @property
    def nx(self) -> int:
        return self.nq + self.nv


def to_lanes(x, k0: int, k1: int):
    """Columns k0:k1 of x (..., d) as a contiguous (k1-k0, L) lanes tensor."""
    return x.reshape(-1, x.shape[-1])[:, k0:k1].T.contiguous()


def from_lanes(y, lead):
    """(d, L) or (d0, d1, L) lanes tensor -> (*lead, d) or (*lead, d0, d1)."""
    return y.movedim(-1, 0).reshape(*lead, *y.shape[:-1])


def URDFPlant(path: Optional[str] = None,
              robot: Optional[RobotModel] = None,
              integrator_type: int = 0,
              gravity: float = -9.81,
              use_kernel_fd_grad: bool = True,
              use_kernel_fd: bool = True,
              use_kernel_task: bool = True) -> Plant:
    """URDF rigid-body plant: qdd = Minv(q) (u - c(q, qd)).

    The kernel flags are the counterparts of the JAX plant's use_pallas /
    use_pallas_fd / use_pallas_task: on CUDA tensors they select K1 / K2 /
    K3 (on) or the plain PyTorch versions (off).  CPU tensors always take
    the plain versions."""
    if robot is None:
        if path is None:
            raise ValueError("URDFPlant needs a path or a RobotModel")
        robot = parse_urdf(path)
    n = robot.n
    dyn = LaneDynamics(robot, gravity, use_kernel_fd=use_kernel_fd,
                       use_kernel_fd_grad=use_kernel_fd_grad)
    kin = LaneKinematics(robot, use_kernel_task=use_kernel_task)

    def _qqdu(x, u):
        return to_lanes(x, 0, n), to_lanes(x, n, 2 * n), to_lanes(u, 0, n)

    def xdot(x, u):
        q, qd, uu = _qqdu(x, u)
        qdd = from_lanes(dyn.fd(q, qd, uu), x.shape[:-1])
        return torch.cat([x[..., n:], qdd], dim=-1)

    def dxdot(x, u):
        q, qd, uu = _qqdu(x, u)
        dqdd = from_lanes(dyn.fd_grad(q, qd, uu), x.shape[:-1])  # (..., n, 3n)
        top = x.new_zeros(x.shape[:-1] + (n, 3 * n))
        top[..., :, n:2 * n] = torch.eye(n, dtype=x.dtype, device=x.device)
        return torch.cat([top, dqdd], dim=-2)                   # (..., 2n, 3n)

    step, step_gradient = make_integrator(xdot, dxdot, 2 * n, n,
                                          integrator_type)
    return Plant(name=robot.name, nq=n, nv=n, nu=n,
                 integrator_type=integrator_type, xdot=xdot, dxdot=dxdot,
                 step=step, step_gradient=step_gradient, dynamics=dyn,
                 kinematics=kin, robot=robot)
