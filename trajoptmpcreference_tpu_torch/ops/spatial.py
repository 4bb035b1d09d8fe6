"""Spatial (Plücker) algebra over a leading batch.

Port of trajoptmpcreference_tpu/ops/spatial.py.  Every function takes
6-vectors as (..., 6) and returns 6x6 operators as (..., 6, 6), with any
leading batch dimensions; joint angles are (...,).  The reference's
per-column cross-product loops become single matrix products through
the bilinear identities (ref: GRiD/RBDReference/RBDReference.py:13-116)

  crm(a) @ b = -crm(b) @ a            (motion cross antisymmetry)
  crf(a) @ b =  icrf(b) @ a           (force cross swap identity)

The cross operators are built as one product of the vector with a
constant basis of {0, +-1} entries: each entry is one component times
+-1 plus exact zeros, so the operator equals the JAX package's
element-wise construction for finite inputs, in one operation.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from trajoptmpcreference_tpu_torch.models.robot import REVOLUTE, RobotModel

# (row, col) -> (sign, component) of each operator, as in the JAX package
_CRM = {(0, 1): (-1, 2), (0, 2): (1, 1), (1, 0): (1, 2), (1, 2): (-1, 0),
        (2, 0): (-1, 1), (2, 1): (1, 0), (3, 1): (-1, 5), (3, 2): (1, 4),
        (3, 4): (-1, 2), (3, 5): (1, 1), (4, 0): (1, 5), (4, 2): (-1, 3),
        (4, 3): (1, 2), (4, 5): (-1, 0), (5, 0): (-1, 4), (5, 1): (1, 3),
        (5, 3): (-1, 1), (5, 4): (1, 0)}
_ICRF = {(0, 1): (-1, 2), (0, 2): (1, 1), (0, 4): (-1, 5), (0, 5): (1, 4),
         (1, 0): (1, 2), (1, 2): (-1, 0), (1, 3): (1, 5), (1, 5): (-1, 3),
         (2, 0): (-1, 1), (2, 1): (1, 0), (2, 3): (-1, 4), (2, 4): (1, 3),
         (3, 1): (-1, 5), (3, 2): (1, 4), (4, 0): (1, 5), (4, 2): (-1, 3),
         (5, 0): (-1, 4), (5, 1): (1, 3)}


def _basis_np(kind: str) -> np.ndarray:
    """(6, 36) matrix G with op(v).flatten() = v @ G."""
    G = np.zeros((6, 6, 6))
    table, sign = (_CRM, 1) if kind in ("crm", "crf") else (_ICRF, -1)
    for (r, c), (s, k) in table.items():
        G[k, r, c] = sign * s
    if kind == "crf":
        G = -G.transpose(0, 2, 1)
    return G.reshape(6, 36)


@functools.lru_cache(maxsize=None)
def _basis(kind: str, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_basis_np(kind), dtype=dtype, device=device)


def _op(kind: str, v: torch.Tensor) -> torch.Tensor:
    return (v @ _basis(kind, v.dtype, v.device)).unflatten(-1, (6, 6))


def crm(v):
    """Motion cross-product operator [v x] (ref: RBDReference.py:13-34)."""
    return _op("crm", v)


def crf(v):
    """Force cross-product operator [v x*] = -crm(v)^T
    (ref: RBDReference.py:36-39)."""
    return _op("crf", v)


def icrf(v):
    """Swap operator: icrf(b) @ a == crf(a) @ b (ref: RBDReference.py:42-54)."""
    return _op("icrf", v)


def mv(M, v):
    """M @ v for (..., 6, 6) operators and (..., 6) vectors."""
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def _scale(alpha, x):
    """alpha * x for a float or a (...,) tensor alpha and x (..., 6)."""
    return alpha[..., None] * x if torch.is_tensor(alpha) else alpha * x


def mxS(S, vec, alpha=1.0):
    """alpha * crm(vec) @ S (ref: RBDReference.py:58-63)."""
    return _scale(alpha, mv(crm(vec), S))


def fxS(S, vec, alpha=1.0):
    """alpha * crf(S) @ vec — the force cross of the joint subspace with a
    force vector.  The reference's -mxS(S, vec) (ref: RBDReference.py:
    94-97) holds only for purely angular S (revolute joints): for a
    prismatic S = (0; v), crf(S) f = [v x f_lin; 0] while -crm(f) S =
    [0; v x f_ang] (JAX ops/spatial.py fxS)."""
    return _scale(alpha, mv(crf(S), vec))


def vxIv(v, Imat):
    """crf(v) @ (Imat @ v) (ref: RBDReference.py:99-116)."""
    return mv(crf(v), mv(Imat, v))


def spatial_inv(X):
    """Closed-form inverse of a spatial motion transform: any product of
    rotation / translation transforms is [[R, 0], [B, R]] with R a
    rotation, whose inverse is [[R^T, 0], [-R^T B R^T, R^T]]."""
    R = X[..., :3, :3]
    B = X[..., 3:, :3]
    Rt = R.transpose(-1, -2)
    top = torch.cat([Rt, torch.zeros_like(Rt)], dim=-1)
    bot = torch.cat([-(Rt @ B) @ Rt, Rt], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _skew(a):
    z = torch.zeros_like(a[..., 0])
    return torch.stack([
        torch.stack([z, -a[..., 2], a[..., 1]], dim=-1),
        torch.stack([a[..., 2], z, -a[..., 0]], dim=-1),
        torch.stack([-a[..., 1], a[..., 0], z], dim=-1),
    ], dim=-2)


def _const(a, like):
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def _axis_ops(axis, like):
    """(I, [a]x, [a]x^2) of a joint axis in like's dtype and device."""
    A = _skew(_const(axis, like))
    return _const(np.eye(3), like), A, A @ A


def _rotation(I3, A, A2, theta):
    """I - sin(t) A + (1 - cos(t)) A2 over theta's batch."""
    st = torch.sin(theta)[..., None, None]
    ct = (1.0 - torch.cos(theta))[..., None, None]
    return I3 - st * A + ct * A2


def joint_free_rotation(axis, theta):
    """Featherstone rotation E_free(theta) = R_axis(theta)^T for a unit axis:
    E = I - sin(t) [a]x + (1 - cos(t)) [a]x^2 (ref: SpatialAlgebra.py:48-64),
    (..., 3, 3) over theta (...,)."""
    return _rotation(*_axis_ops(axis, theta), theta)


def _free_times(jtype, I3, A, A2, Xf, theta):
    """X_free(theta) @ X_fixed from the axis' skew A, A2 = A @ A, X_fixed.

    Revolute: X_free = blkdiag(E, E), so each 3-row half of X_fixed is
    rotated by E.  Prismatic: X_free = [[I, 0], [-skew(a t), I]]."""
    top, bot = Xf[..., :3, :], Xf[..., 3:, :]
    if jtype == REVOLUTE:
        E = _rotation(I3, A, A2, theta)
        return torch.cat([E @ top, E @ bot], dim=-2)
    shift = -(theta[..., None, None] * A) @ top
    return torch.cat([top.expand(shift.shape), shift + bot], dim=-2)


def _hom(jtype, I3, A, A2, Ef, tf, ax, e4, theta):
    """The homogeneous transform of joint_hom_transform from the joint's
    constants (e4 = (0, 0, 0, 1)), with no write into a tensor."""
    if jtype == REVOLUTE:
        R = (_rotation(I3, A, A2, theta) @ Ef).transpose(-1, -2)
        t = tf.expand(R.shape[:-2] + (3,))
    else:
        R = Ef.T.expand(theta.shape + (3, 3))
        t = ax * theta[..., None] + tf
    top = torch.cat([R, t[..., None]], dim=-1)
    return torch.cat([top, e4.expand(top.shape[:-2] + (1, 4))], dim=-2)


def joint_spatial_transform(jtype: int, axis, X_fixed, theta):
    """X(theta) = X_free(theta) @ X_fixed (ref: Joint.py:88), (..., 6, 6)."""
    return _free_times(jtype, *_axis_ops(axis, theta), _const(X_fixed, theta),
                       theta)


def joint_transforms(robot: RobotModel, q):
    """All n spatial transforms for configurations q (..., n): (..., n, 6, 6)
    (ref: Robot.py:218-240)."""
    return torch.stack([
        joint_spatial_transform(robot.joint_type[j], robot.axis[j],
                                robot.X_fixed[j], q[..., j])
        for j in range(robot.n)], dim=-3)


def joint_hom_transform(robot: RobotModel, j: int, theta):
    """Homogeneous transform H_j(theta): child-joint frame -> parent frame,
    H = [[(E_free(theta) @ E_fixed)^T, t_free(theta) + t_fixed], [0, 1]]
    (ref: Joint.py:91-95), (..., 4, 4).  Built without writes into
    tensors that derive from theta, so torch.func can differentiate it."""
    return _hom(robot.joint_type[j], *_axis_ops(robot.axis[j], theta),
                _const(robot.E_fixed[j], theta), _const(robot.t_fixed[j], theta),
                _const(robot.axis[j], theta), _const([0.0, 0.0, 0.0, 1.0], theta),
                theta)
