"""Plant layer: dynamics + integrator as batched functions.

Port of trajoptmpcreference_tpu/models/plants.py: ``URDFPlant`` (ref:
TrajoptPlant.py:274-332) and the analytic plants ``DoubleIntegratorPlant``,
``PendulumPlant`` and ``CartPolePlant``, each with its Jacobian written by
hand (the JAX cart-pole's ``jax.jacfwd`` becomes the closed form).

Every function takes x (..., nx) and u (..., nu) with any leading batch
dimensions.  The URDF plant with lanes (the default) flattens them onto
the lane axis of the dynamics (ops/lanes.LaneDynamics), so one call over
a whole (scenario x knot) batch is one kernel launch on the card; without
lanes it runs the per-sample dynamics and kinematics (ops/rbd.py,
ops/kinematics.Kinematics), plain PyTorch that reaches no kernel.  The
analytic plants are plain PyTorch.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch

from trajoptmpcreference_tpu_torch.models.robot import RobotModel
from trajoptmpcreference_tpu_torch.models.urdf import parse_urdf
from trajoptmpcreference_tpu_torch.ops.integrators import make_integrator
from trajoptmpcreference_tpu_torch.ops.kinematics import (
    Kinematics,
    LaneKinematics,
    make_kinematics,
)
from trajoptmpcreference_tpu_torch.ops.lanes import (
    LaneDynamics,
    from_lanes,
    to_lanes,
)
from trajoptmpcreference_tpu_torch.ops.rbd import RBD, make_rbd


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
    rbd: Optional[RBD] = None
    dynamics: Optional[LaneDynamics] = None
    kinematics: Optional[Union[Kinematics, LaneKinematics]] = None
    robot: Optional[RobotModel] = None

    @property
    def nx(self) -> int:
        return self.nq + self.nv

    def get_num_pos(self):
        return self.nq

    def get_num_vel(self):
        return self.nv

    def get_num_cntrl(self):
        return self.nu


def URDFPlant(path: Optional[str] = None,
              robot: Optional[RobotModel] = None,
              integrator_type: int = 0,
              gravity: float = -9.81,
              options: Optional[dict] = None,
              use_lanes: bool = True,
              use_kernel_fd_grad: bool = True,
              use_kernel_fd: bool = True,
              use_kernel_task: bool = True) -> Plant:
    """URDF rigid-body plant: qdd = Minv(q) (u - c(q, qd))
    (ref: TrajoptPlant.py:274-332).  ``options`` may give
    ``path_to_urdf`` and ``gravity``, which take precedence.

    use_lanes: fd / fd_grad / task_vec over the lanes dynamics and
    kinematics, where the kernel flags (the JAX plant's use_pallas /
    use_pallas_fd / use_pallas_task) select K1 / K2 / K3 on CUDA tensors
    (on) or the plain PyTorch versions (off); CPU tensors always take the
    plain versions.  Without lanes the plant runs the per-sample
    ``rbd.fd`` / ``rbd.fd_grad`` and ``Kinematics`` on every device and
    the kernel flags are not read, as in the JAX package.  Either plant
    carries ``rbd``."""
    if options:
        path = options.get("path_to_urdf", path)
        gravity = options.get("gravity", gravity)
    if robot is None:
        if path is None:
            raise ValueError("URDFPlant needs a path or a RobotModel")
        robot = parse_urdf(path)
    n = robot.n
    rbd = make_rbd(robot)
    dyn = None
    kin = make_kinematics(robot, use_lanes=use_lanes,
                          use_kernel_task=use_kernel_task)
    if use_lanes:
        dyn = LaneDynamics(robot, gravity, use_kernel_fd=use_kernel_fd,
                           use_kernel_fd_grad=use_kernel_fd_grad)

        def _qqdu(x, u):
            return to_lanes(x, 0, n), to_lanes(x, n, 2 * n), to_lanes(u, 0, n)

        def qdd(x, u):
            return from_lanes(dyn.fd(*_qqdu(x, u)), x.shape[:-1])

        def dqdd(x, u):
            return from_lanes(dyn.fd_grad(*_qqdu(x, u)), x.shape[:-1])
    else:
        def qdd(x, u):
            return rbd.fd(x[..., :n], x[..., n:], u, gravity)

        def dqdd(x, u):
            return rbd.fd_grad(x[..., :n], x[..., n:], u, gravity)

    def xdot(x, u):
        return torch.cat([x[..., n:], qdd(x, u)], dim=-1)

    def dxdot(x, u):
        d = dqdd(x, u)                                          # (..., n, 3n)
        top = x.new_zeros(x.shape[:-1] + (n, 3 * n))
        top[..., :, n:2 * n] = torch.eye(n, dtype=x.dtype, device=x.device)
        return torch.cat([top, d], dim=-2)                      # (..., 2n, 3n)

    step, step_gradient = make_integrator(xdot, dxdot, 2 * n, n,
                                          integrator_type)
    return Plant(name=robot.name, nq=n, nv=n, nu=n,
                 integrator_type=integrator_type, xdot=xdot, dxdot=dxdot,
                 step=step, step_gradient=step_gradient, rbd=rbd,
                 dynamics=dyn, kinematics=kin, robot=robot)


# ------------------------------------------------------- analytic plants

def _build(name, nq, nv, nu, xdot, dxdot, integrator_type) -> Plant:
    step, step_gradient = make_integrator(xdot, dxdot, nq + nv, nu,
                                          integrator_type)
    return Plant(name=name, nq=nq, nv=nv, nu=nu,
                 integrator_type=integrator_type, xdot=xdot, dxdot=dxdot,
                 step=step, step_gradient=step_gradient)


def _rows(*rows):
    """Stack rows of (...,) entries into (..., len(rows), len(rows[0]))."""
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def DoubleIntegratorPlant(mass: float = 1.0, integrator_type: int = 0) -> Plant:
    """1-D double integrator: qdd = u / m."""

    def xdot(x, u):
        return torch.stack([x[..., 1], u[..., 0] / mass], dim=-1)

    def dxdot(x, u):
        z = torch.zeros_like(x[..., 0])
        one = torch.ones_like(z)
        return _rows((z, one, z), (z, z, one / mass))

    return _build("double_integrator", 1, 1, 1, xdot, dxdot, integrator_type)


def PendulumPlant(mass: float = 1.0, length: float = 1.0,
                  damping: float = 0.0, gravity: float = 9.81,
                  integrator_type: int = 0) -> Plant:
    """Point-mass pendulum: ml^2 qdd = u - m g l sin(q) - b qd.
    theta = 0 hanging down; swing-up goal theta = pi
    (ref: examples/pendulum.py:13-16)."""
    ml2 = mass * length * length
    mgl = mass * gravity * length

    def xdot(x, u):
        q, qd = x[..., 0], x[..., 1]
        qdd = (u[..., 0] - mgl * torch.sin(q) - damping * qd) / ml2
        return torch.stack([qd, qdd], dim=-1)

    def dxdot(x, u):
        q = x[..., 0]
        z = torch.zeros_like(q)
        one = torch.ones_like(q)
        return _rows((z, one, z),
                     (-mgl * torch.cos(q) / ml2, -damping / ml2 * one,
                      one / ml2))

    return _build("pendulum", 1, 1, 1, xdot, dxdot, integrator_type)


def CartPolePlant(cart_mass: float = 1.0, pole_mass: float = 0.1,
                  pole_length: float = 0.5, gravity: float = 9.81,
                  integrator_type: int = 0) -> Plant:
    """Cart-pole with force control on the cart.

    State [p, theta, pd, thetad], theta = 0 pole down; the control acts only
    on the cart (nu = 1).  dxdot is the closed-form Jacobian of the
    accelerations (the JAX plant takes it by forward-mode autodiff)."""
    mc, mp, l, g = cart_mass, pole_mass, pole_length, gravity

    def _parts(x, u):
        th, thd = x[..., 1], x[..., 3]
        s, c = torch.sin(th), torch.cos(th)
        denom = mc + mp * s * s
        pdd = (u[..., 0] + mp * s * (l * thd * thd + g * c)) / denom
        thdd = ((-u[..., 0] * c - mp * l * thd * thd * c * s
                 - (mc + mp) * g * s) / (l * denom))
        return s, c, thd, denom, pdd, thdd

    def xdot(x, u):
        *_, pdd, thdd = _parts(x, u)
        return torch.cat([x[..., 2:], torch.stack([pdd, thdd], dim=-1)], dim=-1)

    def dxdot(x, u):
        s, c, thd, denom, pdd, thdd = _parts(x, u)
        ddenom = 2 * mp * s * c                      # d denom / d theta
        dpdd_th = (mp * (c * (l * thd * thd + g * c) - g * s * s)
                   - pdd * ddenom) / denom
        dthdd_th = ((u[..., 0] * s - mp * l * thd * thd * (c * c - s * s)
                     - (mc + mp) * g * c) / (l * denom) - thdd * ddenom / denom)
        z = torch.zeros_like(s)
        one = torch.ones_like(s)
        return _rows((z, z, one, z, z),
                     (z, z, z, one, z),
                     (z, dpdd_th, z, 2 * mp * s * l * thd / denom, one / denom),
                     (z, dthdd_th, z, -2 * mp * l * thd * c * s / (l * denom),
                      -c / (l * denom)))

    return _build("cartpole", 2, 2, 1, xdot, dxdot, integrator_type)
