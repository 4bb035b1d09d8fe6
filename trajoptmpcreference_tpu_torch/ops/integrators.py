"""Explicit integrators with exact analytic gradient composition.

Port of trajoptmpcreference_tpu/ops/integrators.py (ref:
TrajoptPlant.py:24-27,83-270): 0 euler, 1 semi-implicit euler, 2 midpoint,
3 rk3, 4 rk4.  Euler and semi-implicit gradients match the reference
formulas exactly; for midpoint, rk3 and rk4 both the step and its (A, B)
Jacobians are the exact chain-rule composition of the stage Jacobians, as
in the JAX package (the reference's own rk3/rk4 gradients reuse dxdot1
for the B terms, README.md:284-296).

Every function takes x (..., nx) and u (..., nu) with any leading batch
dimensions.  Each stage calls ``xdot`` / ``dxdot`` once, as the JAX
package does: on the URDF plant every call is one K2 / K1 launch.
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
    if integrator_type not in (0, 1, 2, 3, 4):
        raise ValueError(
            "Invalid integrator; options are [0: euler, 1: semi-implicit euler,"
            " 2: midpoint, 3: rk3, 4: rk4]")

    def _eye(n, like):
        return torch.eye(n, dtype=like.dtype, device=like.device)

    def _split(D):
        return D[..., :nx], D[..., nx:]

    if integrator_type == 0:  # euler (ref: TrajoptPlant.py:92-108)
        def step(x, u, dt):
            return x + dt * xdot(x, u)

        def step_gradient(x, u, dt):
            D = dxdot(x, u)
            A = _eye(nx, x) + dt * D[..., :nx]
            B = dt * D[..., nx:]
            return A, B

    elif integrator_type == 1:  # semi-implicit euler (ref: TrajoptPlant.py:110-138)
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

    elif integrator_type == 2:  # midpoint
        def step(x, u, dt):
            f1 = xdot(x, u)
            f2 = xdot(x + 0.5 * dt * f1, u)
            return x + dt * f2

        def step_gradient(x, u, dt):
            I = _eye(nx, x)
            D1x, D1u = _split(dxdot(x, u))
            mid = x + 0.5 * dt * xdot(x, u)
            D2x, D2u = _split(dxdot(mid, u))
            A = I + dt * (D2x @ (I + 0.5 * dt * D1x))
            B = dt * (0.5 * dt * (D2x @ D1u) + D2u)
            return A, B

    elif integrator_type == 3:  # rk3 (Butcher per ref: TrajoptPlant.py:172-178)
        def step(x, u, dt):
            f1 = xdot(x, u)
            f2 = xdot(x + 0.5 * dt * f1, u)
            f3 = xdot(x + 0.75 * dt * f2, u)
            return x + (dt / 9.0) * (2.0 * f1 + 3.0 * f2 + 4.0 * f3)

        def step_gradient(x, u, dt):
            I = _eye(nx, x)
            f1 = xdot(x, u)
            D1x, D1u = _split(dxdot(x, u))
            p1 = x + 0.5 * dt * f1
            f2 = xdot(p1, u)
            D2x, D2u = _split(dxdot(p1, u))
            p2 = x + 0.75 * dt * f2
            D3x, D3u = _split(dxdot(p2, u))
            # stage sensitivities
            G1x, G1u = D1x, D1u
            G2x = D2x @ (I + 0.5 * dt * G1x)
            G2u = D2x @ (0.5 * dt * G1u) + D2u
            G3x = D3x @ (I + 0.75 * dt * G2x)
            G3u = D3x @ (0.75 * dt * G2u) + D3u
            A = I + (dt / 9.0) * (2.0 * G1x + 3.0 * G2x + 4.0 * G3x)
            B = (dt / 9.0) * (2.0 * G1u + 3.0 * G2u + 4.0 * G3u)
            return A, B

    else:  # rk4 (ref: TrajoptPlant.py:215-270)
        def step(x, u, dt):
            f1 = xdot(x, u)
            f2 = xdot(x + 0.5 * dt * f1, u)
            f3 = xdot(x + 0.5 * dt * f2, u)
            f4 = xdot(x + dt * f3, u)
            return x + (dt / 6.0) * (f1 + 2.0 * f2 + 2.0 * f3 + f4)

        def step_gradient(x, u, dt):
            I = _eye(nx, x)
            f1 = xdot(x, u)
            D1x, D1u = _split(dxdot(x, u))
            p1 = x + 0.5 * dt * f1
            f2 = xdot(p1, u)
            D2x, D2u = _split(dxdot(p1, u))
            p2 = x + 0.5 * dt * f2
            f3 = xdot(p2, u)
            D3x, D3u = _split(dxdot(p2, u))
            p3 = x + dt * f3
            D4x, D4u = _split(dxdot(p3, u))
            G1x, G1u = D1x, D1u
            G2x = D2x @ (I + 0.5 * dt * G1x)
            G2u = D2x @ (0.5 * dt * G1u) + D2u
            G3x = D3x @ (I + 0.5 * dt * G2x)
            G3u = D3x @ (0.5 * dt * G2u) + D3u
            G4x = D4x @ (I + dt * G3x)
            G4u = D4x @ (dt * G3u) + D4u
            A = I + (dt / 6.0) * (G1x + 2.0 * G2x + 2.0 * G3x + G4x)
            B = (dt / 6.0) * (G1u + 2.0 * G2u + 2.0 * G3u + G4u)
            return A, B

    return step, step_gradient
