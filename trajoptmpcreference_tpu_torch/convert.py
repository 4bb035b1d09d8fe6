"""Build the port's objects from JAX-package objects given as numpy arrays
or plain dicts (never importing jax), so one configuration can drive both
packages in the tests."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from trajoptmpcreference_tpu_torch.models.robot import RobotModel
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
    caller asks for another); ``xg`` may be (d,) or per-scenario (B, d)."""
    device = require_device(device)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    return QuadraticCostParams(t(Q), t(QF), t(R), t(xg))


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
