"""Build the port's objects from JAX-package objects given as numpy arrays
or plain dicts (never importing jax), so one configuration can drive both
packages in the tests."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from trajoptmpcreference_tpu_torch.models import plants as P
from trajoptmpcreference_tpu_torch.models.robot import RobotModel
from trajoptmpcreference_tpu_torch.solvers.constraints import (
    BoxLimitSpec,
    ConstraintSet,
    SoftLimitState,
)
from trajoptmpcreference_tpu_torch.solvers.costs import QuadraticCostParams
from trajoptmpcreference_tpu_torch.solvers.sqp import SQPOptions


def robot_from_numpy(obj) -> RobotModel:
    """The port's RobotModel from any object with the RobotModel fields
    (e.g. the JAX package's)."""
    arr = lambda name: np.array(getattr(obj, name), dtype=np.float64)
    return RobotModel(
        name=str(obj.name),
        parent=tuple(int(p) for p in obj.parent),
        joint_type=tuple(int(t) for t in obj.joint_type),
        axis=arr("axis"), X_fixed=arr("X_fixed"), E_fixed=arr("E_fixed"),
        t_fixed=arr("t_fixed"), I_spatial=arr("I_spatial"),
        damping=arr("damping"))


def require_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device on a machine without
    CUDA raises (the entry points default to the card and never fall back
    to the CPU: pass device="cpu" for that)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} asked for, but CUDA is not "
                           "available here; pass device='cpu' to run on the "
                           "CPU")
    return device


def cost_params_from_numpy(Q, QF, R, xg, dtype=torch.float64, device="cuda"):
    """QuadraticCostParams of tensors on ``device`` (the card unless the
    caller asks for another); ``xg`` may be (d,) or per-scenario (B, d).
    A JAX QuadraticCostParams passes as ``cost_params_from_numpy(*p)``."""
    device = require_device(device)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    return QuadraticCostParams(t(Q), t(QF), t(R), t(xg))


# the analytic plants' parameters, by the JAX plant's name
ANALYTIC_PLANTS = {
    "double_integrator": (P.DoubleIntegratorPlant, ("mass",)),
    "pendulum": (P.PendulumPlant, ("mass", "length", "damping", "gravity")),
    "cartpole": (P.CartPolePlant,
                 ("cart_mass", "pole_mass", "pole_length", "gravity")),
}


def analytic_plant_from_numpy(name: str, integrator_type: int = 0,
                              **params) -> P.Plant:
    """The port's analytic plant ``name`` ("double_integrator",
    "pendulum" or "cartpole", the JAX plant's ``name``) with the
    parameters the JAX constructor took, as plain floats (numpy scalars
    and arrays of one element are accepted); an unknown name or parameter
    raises."""
    if name not in ANALYTIC_PLANTS:
        raise ValueError(f"unknown analytic plant {name!r}; options are "
                         f"{sorted(ANALYTIC_PLANTS)}")
    ctor, names = ANALYTIC_PLANTS[name]
    unknown = set(params) - set(names)
    if unknown:
        raise ValueError(f"unknown {name} parameters: {sorted(unknown)}")
    kw = {k: float(np.asarray(v).reshape(())) for k, v in params.items()}
    return ctor(integrator_type=int(integrator_type), **kw)


def sqp_kwargs_from_jax(method="N", options=None, use_pallas_pcg=False,
                        exact_schur="thomas") -> dict:
    """Keyword arguments of the port's ``make_sqp`` for a JAX ``make_sqp(...,
    method=..., options=..., use_pallas_pcg=..., exact_schur=...)`` call.
    ``method`` may be a string or either package's SQPSolverMethods member;
    ``options`` a JAX SQPOptions, its ``dataclasses.asdict`` or None;
    use_pallas_pcg becomes use_kernel_pcg."""
    if options is not None and not isinstance(options, dict):
        options = dataclasses.asdict(options)
    return dict(method=str(getattr(method, "value", method)),
                options=None if options is None else options_from_dict(options),
                exact_schur=exact_schur, use_kernel_pcg=bool(use_pallas_pcg))


def options_from_dict(d: dict) -> SQPOptions:
    """SQPOptions from ``dataclasses.asdict`` of the JAX SQPOptions; an
    unknown field raises (the port's options carry every JAX field)."""
    known = {f.name for f in dataclasses.fields(SQPOptions)}
    unknown = set(d) - known
    if unknown:
        raise ValueError(f"unknown SQPOptions fields: {sorted(unknown)}")
    return SQPOptions(**d)


def constraint_set_from_numpy(obj) -> ConstraintSet:
    """The port's ConstraintSet from any object with the ConstraintSet
    fields (nq, nv, nu, N, limits), each limit with the BoxLimitSpec
    fields (e.g. the JAX package's)."""
    names = [f.name for f in dataclasses.fields(BoxLimitSpec)]
    limits = []
    for l in obj.limits:
        kw = {n: getattr(l, n) for n in names}
        kw["lower"] = tuple(float(v) for v in l.lower)
        kw["upper"] = tuple(float(v) for v in l.upper)
        limits.append(BoxLimitSpec(**kw))
    return ConstraintSet(int(obj.nq), int(obj.nv), int(obj.nu), int(obj.N),
                         tuple(limits))


def soft_state_from_numpy(states, dtype=torch.float64, device="cuda"):
    """A tuple of the port's SoftLimitState from (mu, lam, phi) triples of
    arrays (e.g. the JAX package's SoftLimitState), keeping their shapes,
    as tensors on ``device`` (the card unless the caller asks for
    another)."""
    device = require_device(device)
    t = lambda a: torch.as_tensor(np.array(a), dtype=dtype, device=device)
    return tuple(SoftLimitState(t(st[0]), t(st[1]), t(st[2]))
                 for st in states)
