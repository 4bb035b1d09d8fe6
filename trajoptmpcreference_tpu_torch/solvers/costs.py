"""Cost layer: quadratic, task-space (URDF) and closed-form arm costs as
batched functions.

Port of trajoptmpcreference_tpu/solvers/costs.py (ref:
TrajoptCost.py:12-656): ``Cost``, ``QuadraticCostParams``,
``QuadraticCost``, ``UrdfCost`` (every ``hess_mode``, and ``ref_compat``),
``NumericalCost``, ``ArmCost`` and ``total_cost_diff``, the per-stage
merit difference that the SQP and iLQR line searches share.

Every stage function takes x (..., K, nx), u (..., K, nu) and the knot
indices k (K,), with any leading batch dimensions, and returns per-knot
values (..., K) / gradients (..., K, nx+nu) / Hessians (..., K, n, n).
The JAX Cost's separate stage_hessian / term_hessian become
``stage_derivatives`` / ``term_derivatives``, which return the gradient and
the Hessian from one task-space Jacobian (eager PyTorch has no
common-subexpression pass to share it between two calls).
The params' goal ``xg`` must broadcast against (..., K, 2k): the solver
passes it as (B, 1, 2k) for per-scenario goals.  ``jax.grad`` /
``jax.hessian`` / ``jax.jacfwd`` become ``torch.func`` over one sample at a
time, vmapped over the flattened leading dimensions (``_per_sample``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from trajoptmpcreference_tpu_torch.models.plants import Plant


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
    # None => total_cost_diff falls back to a difference of stage values.
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


def _mv(v, M):
    """v' M over the last dim: (..., d) x (..., d, e) -> (..., e)."""
    return (v[..., None, :] @ M)[..., 0, :]


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


def _per_sample(fn, x, Q, xg):
    """fn(x_i, Q_i, xg_i) for every sample i of x (..., d): Q (..., e, e)
    and xg (..., e) are broadcast to x's leading dims, the samples
    flattened and mapped by torch.func.vmap."""
    lead = x.shape[:-1]
    flat = lambda a, tail: a.expand(lead + tail).reshape((-1,) + tail)
    out = torch.func.vmap(fn)(flat(x, x.shape[-1:]), flat(Q, Q.shape[-2:]),
                              flat(xg, xg.shape[-1:]))
    return out.reshape(lead + out.shape[1:])


def _block_hessian(hx, R, nx, nu):
    """[[hx, 0], [0, R]] over hx's leading dims."""
    H = hx.new_zeros(hx.shape[:-2] + (nx + nu, nx + nu))
    H[..., :nx, :nx] = hx
    H[..., nx:, nx:] = R
    return H


def QuadraticCost(Q, QF, R, xg, QF_start: Optional[int] = None) -> Cost:
    """0.5 (x-xg)^T Q (x-xg) + 0.5 u^T R u (ref: TrajoptCost.py:24-104)."""
    nx, nu = Q.shape[0], R.shape[0]
    params0 = QuadraticCostParams(Q, QF, R, xg)

    def stage_value(p, x, u, k):
        cQ = _currQ(p, k, QF_start, False)
        dx = x - p.xg
        return 0.5 * _quad(cQ, dx, dx) + 0.5 * _quad(p.R, u, u)

    def term_value(p, x, k):
        dx = x - p.xg
        return 0.5 * _quad(p.QF, dx, dx)

    def stage_gradient(p, x, u, k):
        cQ = _currQ(p, k, QF_start, False)
        return torch.cat([_mv(x - p.xg, cQ), _mv(u, p.R)], dim=-1)

    def term_gradient(p, x, k):
        return _mv(x - p.xg, p.QF)

    def stage_derivatives(p, x, u, k):
        cQ = _currQ(p, k, QF_start, False)
        hx = cQ.expand(x.shape[:-1] + (nx, nx))
        return stage_gradient(p, x, u, k), _block_hessian(hx, p.R, nx, nu)

    def term_derivatives(p, x, k):
        return term_gradient(p, x, k), p.QF.expand(x.shape[:-1] + (nx, nx))

    def stage_value_diff(p, x, u, xc, uc, k):
        cQ = _currQ(p, k, QF_start, False)
        # residual difference is exactly xc - x (xg cancels analytically)
        return (0.5 * _quad(cQ, xc - x, (xc - p.xg) + (x - p.xg))
                + _quad_diff(p.R, u, uc))

    def term_value_diff(p, x, xc, k):
        return 0.5 * _quad(p.QF, xc - x, (xc - p.xg) + (x - p.xg))

    return Cost(nx, nu, stage_value, term_value, stage_gradient,
                term_gradient, stage_derivatives, term_derivatives, params0,
                stage_value_diff=stage_value_diff,
                term_value_diff=term_value_diff)


def UrdfCost(plant: Plant, Q, QF, R, xg, QF_start: Optional[int] = None,
             hess_mode: int = 0, ref_compat: bool = False) -> Cost:
    """Task-space cost on [ee position; ee velocity] for a URDF arm
    (ref: TrajoptCost.py:371-569).

    delta = [ee_pos_k(q); J(q) qd] - xg with k = min(3, n) task dims.  The
    gradient uses the total-state Jacobian [[J, 0], [dJ/dq.qd, J]]
    (ref: TrajoptCost.py:437-458).

    hess_mode (ref: TrajoptCost.py:391-395,482-519):
      0: Gauss-Newton (Q J_tot)^T J_tot   [reference default]
      1: exact — torch.func.jacfwd of the analytic gradient.  An oracle for
         validation, as in the JAX package: it differentiates the plain
         per-sample kinematics (``plant.kinematics.plain``, plain PyTorch
         on every device), never kernel K3, one sample at a time under
         torch.func.vmap
      2: grad^T grad outer product
      3: zero state Hessian

    ref_compat (2-link only): reproduce the reference's hand-coded dJdq
    shortcut (ref: RBDReference.py:256-266) *including its sign error* on
    the d J[1,0]/dq row — for golden-parity tests only.

    The cost reads the plant's kinematics through the state-level methods
    that the per-sample ``Kinematics`` and ``LaneKinematics`` share
    (``task_vec_x``, ``jacobian_tot_state_x``, ``jacobian_x``), so it runs
    unchanged on a plant with lanes or without."""
    if plant.kinematics is None:
        raise ValueError("UrdfCost requires a URDF plant with kinematics")
    if hess_mode not in (0, 1, 2, 3):
        raise ValueError(f"invalid hess_mode {hess_mode}")
    kin = plant.kinematics
    n = plant.nq
    nx, nu = plant.nx, plant.nu
    if ref_compat and n != 2:
        raise ValueError("ref_compat reproduces the reference's 2-link-only "
                         "dJdq shortcut (ref: RBDReference.py:256-266)")
    params0 = QuadraticCostParams(Q, QF, R, xg)

    def delta_x(p, x):
        # one frames pass: kernel K3 on CUDA tensors for a lanes plant
        return kin.task_vec_x(x) - p.xg

    def _jt(x):
        if not ref_compat:
            return kin.jacobian_tot_state_x(x)
        # reference 2-link shortcut, incl. its dJ[1,0]/dq sign
        # (ref: RBDReference.py:256-266, 318-336)
        J = kin.jacobian_x(x)                               # (..., 2, 2)
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

    def _grad_plain(x, Q_, xg_):
        # one sample (2n,) through the plain per-sample kinematics
        Jt = kin.plain.jacobian_tot_state(x[:n], x[n:])      # (2k, 2n)
        d = kin.plain.task_vec(x[:n], x[n:]) - xg_
        return (d @ Q_) @ Jt

    def _hess_x(p, x, cQ, Jt, gx):
        if hess_mode == 0:
            return (cQ @ Jt).transpose(-1, -2) @ Jt
        if hess_mode == 1:
            return _per_sample(torch.func.jacfwd(_grad_plain), x, cQ, p.xg)
        if hess_mode == 2:
            return gx[..., :, None] * gx[..., None, :]
        return x.new_zeros(x.shape[:-1] + (nx, nx))

    def stage_value(p, x, u, k):
        cQ = _currQ(p, k, QF_start, False)
        dx = delta_x(p, x)
        return 0.5 * _quad(cQ, dx, dx) + 0.5 * _quad(p.R, u, u)

    def term_value(p, x, k):
        dx = delta_x(p, x)
        return 0.5 * _quad(p.QF, dx, dx)

    def stage_gradient(p, x, u, k):
        gx = _grad_x(p, x, _currQ(p, k, QF_start, False), _jt(x))
        return torch.cat([gx, _mv(u, p.R)], dim=-1)

    def term_gradient(p, x, k):
        return _grad_x(p, x, p.QF, _jt(x))

    def stage_derivatives(p, x, u, k):
        cQ = _currQ(p, k, QF_start, False)
        Jt = _jt(x)
        gx = _grad_x(p, x, cQ, Jt)
        g = torch.cat([gx, _mv(u, p.R)], dim=-1)
        return g, _block_hessian(_hess_x(p, x, cQ, Jt, gx), p.R, nx, nu)

    def term_derivatives(p, x, k):
        Jt = _jt(x)
        gx = _grad_x(p, x, p.QF, Jt)
        return gx, _hess_x(p, x, p.QF, Jt, gx)

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


def NumericalCost(plant: Plant, Q, QF, R, xg, eps: float = 1e-5,
                  QF_start: Optional[int] = None) -> Cost:
    """Central-difference gradient checker around the task-space cost
    (ref: TrajoptCost.py:573-654).  Gradient by central differences of the
    UrdfCost value, Hessian its outer product — a test oracle, not a
    production cost.  It has no value differences, so the line searches
    take total_cost_diff's fallback."""
    base = UrdfCost(plant, Q, QF, R, xg, QF_start=QF_start)
    nx, nu = base.nx, base.nu

    def _fd_grad(f, z):
        # every +-eps perturbation of z (..., d) in one call of f over a
        # leading (2, d) axis: [0, i] is z + eps e_i, [1, i] is z - eps e_i
        d = z.shape[-1]
        dz = eps * torch.eye(d, dtype=z.dtype, device=z.device)
        dz = dz.reshape((d,) + (1,) * (z.dim() - 1) + (d,))
        v = f(torch.stack([z + dz, z - dz]))
        return torch.movedim((v[0] - v[1]) / (2 * eps), 0, -1)

    def stage_gradient(p, x, u, k):
        z = torch.cat([x, u], dim=-1)
        return _fd_grad(lambda zz: base.stage_value(p, zz[..., :nx],
                                                    zz[..., nx:], k), z)

    def term_gradient(p, x, k):
        return _fd_grad(lambda zz: base.term_value(p, zz, k), x)

    def stage_derivatives(p, x, u, k):
        g = stage_gradient(p, x, u, k)
        return g, g[..., :, None] * g[..., None, :]

    def term_derivatives(p, x, k):
        g = term_gradient(p, x, k)
        return g, g[..., :, None] * g[..., None, :]

    return Cost(nx, nu, base.stage_value, base.term_value, stage_gradient,
                term_gradient, stage_derivatives, term_derivatives,
                base.default_params, xu_coupled=True)


def ArmCost(Q, QF, R, xg, l1: float = 1.0, l2: float = 1.0,
            QF_start: Optional[int] = None) -> Cost:
    """Closed-form 2-link end-effector cost (ref: TrajoptCost.py:111-363):
    the planar kinematics written directly, the state gradient and Hessian
    by torch.func.grad / torch.func.hessian (the JAX package's jax.grad /
    jax.hessian)."""
    params0 = QuadraticCostParams(Q, QF, R, xg)
    nx, nu = 4, 2

    def _delta(xg_, x):
        q1, q2, qd1, qd2 = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
        s1, c1 = torch.sin(q1), torch.cos(q1)
        s12, c12 = torch.sin(q1 + q2), torch.cos(q1 + q2)
        J00, J01 = -l2 * c12 - l1 * c1, -l2 * c12
        J10, J11 = -l2 * s12 - l1 * s1, -l2 * s12
        return torch.stack([-l2 * s12 - l1 * s1, l2 * c12 + l1 * c1,
                            J00 * qd1 + J01 * qd2, J10 * qd1 + J11 * qd2],
                           dim=-1) - xg_

    def _value(x, Q_, xg_):
        d = _delta(xg_, x)
        return 0.5 * _quad(Q_, d, d)

    _grad = torch.func.grad(_value)
    _hess = torch.func.hessian(_value)

    def stage_value(p, x, u, k):
        cQ = _currQ(p, k, QF_start, False)
        dx = _delta(p.xg, x)
        return 0.5 * _quad(cQ, dx, dx) + 0.5 * _quad(p.R, u, u)

    def term_value(p, x, k):
        dx = _delta(p.xg, x)
        return 0.5 * _quad(p.QF, dx, dx)

    def stage_gradient(p, x, u, k):
        gx = _per_sample(_grad, x, _currQ(p, k, QF_start, False), p.xg)
        return torch.cat([gx, _mv(u, p.R)], dim=-1)

    def term_gradient(p, x, k):
        return _per_sample(_grad, x, p.QF, p.xg)

    def stage_derivatives(p, x, u, k):
        hx = _per_sample(_hess, x, _currQ(p, k, QF_start, False), p.xg)
        return stage_gradient(p, x, u, k), _block_hessian(hx, p.R, nx, nu)

    def term_derivatives(p, x, k):
        return (term_gradient(p, x, k),
                _per_sample(_hess, x, p.QF, p.xg))

    def stage_value_diff(p, x, u, xc, uc, k):
        cQ = _currQ(p, k, QF_start, False)
        return (_quad_diff(cQ, _delta(p.xg, x), _delta(p.xg, xc))
                + _quad_diff(p.R, u, uc))

    def term_value_diff(p, x, xc, k):
        return _quad_diff(p.QF, _delta(p.xg, x), _delta(p.xg, xc))

    return Cost(nx, nu, stage_value, term_value, stage_gradient,
                term_gradient, stage_derivatives, term_derivatives, params0,
                stage_value_diff=stage_value_diff,
                term_value_diff=term_value_diff)


def total_cost_diff(cost: Cost, cset, cstate, N: int, X, U, Xc, Uc,
                    cost_params):
    """J(Xc, Uc) - J(X, U) per scenario (...,), summed from per-stage
    differences, the soft penalties included.

    An f32 merit acceptance must resolve cost changes of order
    exit_tolerance while J itself can be 1e4..1e6; subtracting two
    separately-accumulated totals leaves no significant bits.  Summing
    per-stage differences — each in residual form when the cost provides
    stage_value_diff, else a difference of the stage's two values — keeps
    the cancellation at O(stage) magnitudes instead of O(J).  Shared by
    the SQP and iLQR line searches.  X (..., nx, N), U (..., nu, N-1);
    Xc / Uc may carry extra leading dims (a ladder's rungs) that broadcast
    against X / U."""
    from trajoptmpcreference_tpu_torch.solvers import constraints as C

    Xk, Uk = X.transpose(-1, -2), U.transpose(-1, -2)
    Xck, Uck = Xc.transpose(-1, -2), Uc.transpose(-1, -2)
    Xs, XN = Xk[..., :-1, :], Xk[..., -1:, :]
    Xcs, XcN = Xck[..., :-1, :], Xck[..., -1:, :]
    ks = torch.arange(N - 1, device=X.device)
    kN = torch.arange(N - 1, N, device=X.device)
    p = cost_params
    if cost.stage_value_diff is not None:
        ds = cost.stage_value_diff(p, Xs, Uk, Xcs, Uck, ks)
    else:
        ds = cost.stage_value(p, Xcs, Uck, ks) - cost.stage_value(p, Xs, Uk, ks)
    if cost.term_value_diff is not None:
        dN = cost.term_value_diff(p, XN, XcN, kN)
    else:
        dN = cost.term_value(p, XcN, kN) - cost.term_value(p, XN, kN)
    if cset.has_soft():
        ds = ds + (C.stage_soft_value(cset, cstate, Xcs, Uck, ks)
                   - C.stage_soft_value(cset, cstate, Xs, Uk, ks))
        dN = dN + (C.term_soft_value(cset, cstate, XcN, kN)
                   - C.term_soft_value(cset, cstate, XN, kN))
    return ds.sum(-1) + dN[..., 0]
