"""Explicit integrators with exact analytic gradient composition.

Port of trajoptmpcreference_tpu/ops/integrators.py for the slice's two
types (ref: TrajoptPlant.py:24-27,83-138): 0 euler and 1 semi-implicit
euler, whose gradients match the reference formulas exactly.  Midpoint,
rk3 and rk4 (types 2-4) are still to be ported (ROADMAP queue 1).

Every function takes x (..., nx) and u (..., nu) with any leading batch
dimensions.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch


def make_integrator(
    xdot: Callable,       # (x, u) -> (..., nx)
    dxdot: Callable,      # (x, u) -> (..., nx, nx+nu)
    nx: int,
    nu: int,
    integrator_type: int = 0,
) -> Tuple[Callable, Callable]:
    """Returns (step, step_gradient):
    step(x, u, dt) -> x_{k+1};  step_gradient(x, u, dt) -> (A, B)."""
    if integrator_type in (2, 3, 4):
        raise NotImplementedError(
            f"integrator type {integrator_type} (midpoint / rk3 / rk4) is not "
            "ported yet; see ROADMAP.md queue 1")
    if integrator_type not in (0, 1):
        raise ValueError(
            "Invalid integrator; options are [0: euler, 1: semi-implicit euler,"
            " 2: midpoint, 3: rk3, 4: rk4]")

    def _eye(n, like):
        return torch.eye(n, dtype=like.dtype, device=like.device)

    if integrator_type == 0:  # euler (ref: TrajoptPlant.py:92-108)
        def step(x, u, dt):
            return x + dt * xdot(x, u)

        def step_gradient(x, u, dt):
            D = dxdot(x, u)
            A = _eye(nx, x) + dt * D[..., :nx]
            B = dt * D[..., nx:]
            return A, B

    else:  # semi-implicit euler (ref: TrajoptPlant.py:110-138)
        nq = nx // 2

        def step(x, u, dt):
            qdd = xdot(x, u)[..., nq:]
            vkp1 = x[..., nq:] + dt * qdd
            qkp1 = x[..., :nq] + dt * vkp1
            return torch.cat([qkp1, vkp1], dim=-1)

        def step_gradient(x, u, dt):
            dqdd = dxdot(x, u)[..., nq:, :]              # (..., nv, nx+nu)
            zIz = x.new_zeros((nq, nx + nu))
            zIz[:, nq:nx] = _eye(nq, x)
            Iz = x.new_zeros((nx, nx + nu))
            Iz[:, :nx] = _eye(nx, x)
            AB = Iz + dt * torch.cat([zIz + dt * dqdd, dqdd], dim=-2)
            return AB[..., :nx], AB[..., nx:]

    return step, step_gradient
