"""Cost layer: the task-space URDF cost as batched functions.

Port of trajoptmpcreference_tpu/solvers/costs.py for the slice:
``Cost``, ``QuadraticCostParams``, ``_quad_diff``, ``_currQ`` and
``UrdfCost`` with the Gauss-Newton Hessian (``hess_mode=0``) and
``ref_compat`` (ref: TrajoptCost.py:371-569).

Every stage function takes x (..., K, nx), u (..., K, nu) and the knot
indices k (K,), with any leading batch dimensions, and returns per-knot
values (..., K) / gradients (..., K, nx+nu) / Hessians (..., K, n, n).
The JAX Cost's separate stage_hessian / term_hessian become
``stage_derivatives`` / ``term_derivatives``, which return the gradient and
the Hessian from one task-space Jacobian (eager PyTorch has no
common-subexpression pass to share it between two calls).
The params' goal ``xg`` must broadcast against (..., K, 2k): the solver
passes it as (B, 1, 2k) for per-scenario goals.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from trajoptmpcreference_tpu_torch.models.plants import Plant, from_lanes, to_lanes


@dataclasses.dataclass(frozen=True)
class Cost:
    nx: int
    nu: int
    stage_value: Callable      # (params, x, u, k) -> (..., K)
    term_value: Callable       # (params, x, k) -> (..., K)
    stage_gradient: Callable   # (params, x, u, k) -> (..., K, nx+nu)
    term_gradient: Callable    # (params, x, k) -> (..., K, nx)
    stage_derivatives: Callable  # (params, x, u, k) -> (gradient, Hessian)
    term_derivatives: Callable   # (params, x, k) -> (gradient, Hessian)
    default_params: Any
    # Cancellation-safe differences stage(xc,uc) - stage(x,u), computed as
    # 0.5 (rc - r)'Q (rc + r) so the subtraction happens between
    # O(residual) quantities, not O(J) ones (f32 merit acceptance).
    stage_value_diff: Optional[Callable] = None  # (p, x, u, xc, uc, k)
    term_value_diff: Optional[Callable] = None   # (p, x, xc, k)
    # True when the stage Hessian can have nonzero (x, u) cross blocks
    xu_coupled: bool = False


class QuadraticCostParams(NamedTuple):
    Q: torch.Tensor
    QF: torch.Tensor
    R: torch.Tensor
    xg: torch.Tensor


def _quad(M, a, b):
    """a' M b over the last dim (M (d, d) or per-knot (K, d, d))."""
    return ((a[..., None, :] @ M)[..., 0, :] * b).sum(-1)


def _quad_diff(Q, r, rc):
    """0.5 rc'Q rc - 0.5 r'Q r, evaluated as 0.5 (rc-r)'Q (rc+r) (Q
    symmetric) — cancellation-safe in f32 (see Cost.stage_value_diff)."""
    return 0.5 * _quad(Q, rc - r, rc + r)


def _currQ(params, k, QF_start, terminal):
    """QF on the terminal state, or from QF_start onward
    (ref: TrajoptCost.py:40-47)."""
    if terminal or QF_start is None:
        return params.QF if terminal else params.Q
    return torch.where((k >= QF_start)[:, None, None], params.QF, params.Q)


def UrdfCost(plant: Plant, Q, QF, R, xg, QF_start: Optional[int] = None,
             hess_mode: int = 0, ref_compat: bool = False) -> Cost:
    """Task-space cost on [ee position; ee velocity] for a URDF arm
    (ref: TrajoptCost.py:371-569).

    delta = [ee_pos_k(q); J(q) qd] - xg with k = min(3, n) task dims.  The
    gradient uses the total-state Jacobian [[J, 0], [dJ/dq.qd, J]]
    (ref: TrajoptCost.py:437-458); hess_mode 0 is the Gauss-Newton Hessian
    (Q J_tot)^T J_tot, the reference default.  hess_mode 1-3 are still to
    be ported (ROADMAP queue 1).

    ref_compat (2-link only): reproduce the reference's hand-coded dJdq
    shortcut (ref: RBDReference.py:256-266) *including its sign error* on
    the d J[1,0]/dq row — for golden-parity tests only."""
    if plant.kinematics is None:
        raise ValueError("UrdfCost requires a URDF plant with kinematics")
    if hess_mode != 0:
        raise NotImplementedError(
            f"UrdfCost hess_mode={hess_mode} is not ported yet (the slice "
            "runs the Gauss-Newton hess_mode=0); see ROADMAP.md queue 1")
    kin = plant.kinematics
    n = plant.nq
    nx, nu = plant.nx, plant.nu
    if ref_compat and n != 2:
        raise ValueError("ref_compat reproduces the reference's 2-link-only "
                         "dJdq shortcut (ref: RBDReference.py:256-266)")
    params0 = QuadraticCostParams(Q, QF, R, xg)

    def delta_x(p, x):
        # one frames pass: kernel K3 on CUDA tensors (ops/kinematics)
        tv = kin.task_vec(to_lanes(x, 0, n), to_lanes(x, n, 2 * n))
        return from_lanes(tv, x.shape[:-1]) - p.xg

    def _jt(x):
        q, qd = to_lanes(x, 0, n), to_lanes(x, n, 2 * n)
        if not ref_compat:
            return from_lanes(kin.jacobian_tot_state(q, qd), x.shape[:-1])
        # reference 2-link shortcut, incl. its dJ[1,0]/dq sign
        # (ref: RBDReference.py:256-266, 318-336)
        J = from_lanes(kin.jacobian(q), x.shape[:-1])       # (..., 2, 2)
        D = torch.stack([
            -J[..., 1, :],
            torch.stack([-J[..., 1, 1], -J[..., 1, 1]], dim=-1),
            -J[..., 0, :],
            torch.stack([J[..., 0, 1], J[..., 0, 1]], dim=-1),
        ], dim=-2)                                          # (..., 4, 2)
        J2 = (D @ x[..., n:, None])[..., 0].reshape(x.shape[:-1] + (2, 2))
        top = torch.cat([J, torch.zeros_like(J)], dim=-1)
        bot = torch.cat([J2, J], dim=-1)
        return torch.cat([top, bot], dim=-2)

    def _grad_x(p, x, cQ, Jt):
        return ((delta_x(p, x)[..., None, :] @ cQ) @ Jt)[..., 0, :]

    def _ucost(u, R_):
        return (u[..., None, :] @ R_)[..., 0, :]

    def stage_value(p, x, u, k):
        cQ = _currQ(p, k, QF_start, False)
        dx = delta_x(p, x)
        return 0.5 * _quad(cQ, dx, dx) + 0.5 * _quad(p.R, u, u)

    def term_value(p, x, k):
        dx = delta_x(p, x)
        return 0.5 * _quad(p.QF, dx, dx)

    def stage_gradient(p, x, u, k):
        gx = _grad_x(p, x, _currQ(p, k, QF_start, False), _jt(x))
        return torch.cat([gx, _ucost(u, p.R)], dim=-1)

    def term_gradient(p, x, k):
        return _grad_x(p, x, p.QF, _jt(x))

    def stage_derivatives(p, x, u, k):
        cQ = _currQ(p, k, QF_start, False)
        Jt = _jt(x)
        g = torch.cat([_grad_x(p, x, cQ, Jt), _ucost(u, p.R)], dim=-1)
        # Gauss-Newton (Q J_tot)^T J_tot, block-diagonal with R
        H = x.new_zeros(x.shape[:-1] + (nx + nu, nx + nu))
        H[..., :nx, :nx] = (cQ @ Jt).transpose(-1, -2) @ Jt
        H[..., nx:, nx:] = p.R
        return g, H

    def term_derivatives(p, x, k):
        Jt = _jt(x)
        return (_grad_x(p, x, p.QF, Jt),
                (p.QF @ Jt).transpose(-1, -2) @ Jt)

    def stage_value_diff(p, x, u, xc, uc, k):
        cQ = _currQ(p, k, QF_start, False)
        return (_quad_diff(cQ, delta_x(p, x), delta_x(p, xc))
                + _quad_diff(p.R, u, uc))

    def term_value_diff(p, x, xc, k):
        return _quad_diff(p.QF, delta_x(p, x), delta_x(p, xc))

    return Cost(nx, nu, stage_value, term_value, stage_gradient,
                term_gradient, stage_derivatives, term_derivatives, params0,
                stage_value_diff=stage_value_diff,
                term_value_diff=term_value_diff)
