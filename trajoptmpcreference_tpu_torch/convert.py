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


def cost_params_from_numpy(Q, QF, R, xg, dtype=torch.float64, device="cpu"):
    """QuadraticCostParams of tensors; ``xg`` may be (d,) or per-scenario
    (B, d)."""
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    return QuadraticCostParams(t(Q), t(QF), t(R), t(xg))


def options_from_dict(d: dict) -> SQPOptions:
    """SQPOptions from ``dataclasses.asdict`` of the JAX SQPOptions; an
    unknown field raises (the port's options carry every JAX field)."""
    known = {f.name for f in dataclasses.fields(SQPOptions)}
    unknown = set(d) - known
    if unknown:
        raise ValueError(f"unknown SQPOptions fields: {sorted(unknown)}")
    return SQPOptions(**d)
