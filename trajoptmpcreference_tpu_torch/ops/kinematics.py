"""End-effector kinematics, per sample and over lanes, and kernel K3.

Port of trajoptmpcreference_tpu/ops/kinematics.py in its two forms:

* ``Kinematics``, the per-sample functions (``make_kinematics`` without
  lanes): every function takes q, qd as (..., n) with any leading batch
  dimensions, and nothing reaches a kernel;
* ``LaneKinematics``, the lanes forms (``frames_L``, ``jac_full_L``,
  ``djdq_L``, ``jt_L``, ``task_vec_L``): joint vectors as (n, L), lane-
  minor outputs, and ``task_vec`` dispatching to K3 on the card.

Both share the state-level methods the costs call (``task_vec_x``,
``jacobian_tot_state_x``, ``jacobian_x``, ``ee_pos_x``: a state x (...,
2n) with leading batch dimensions), so a cost works unchanged on either.
All quantities come from ONE forward pass of world-frame transforms via
geometric (screw) recursions:

  revolute j:  J[:, j] = w_j x (p - o_j)
  dJ[:, j]/dq_l = (w_l x w_j) x (p - o_j) + w_j x (w_l x (p - o_j)),  l <= j
                = w_j x J[:, l],                                      l  > j

with w_j / o_j the world joint axis / origin and p the end-effector point
(``offset`` in the leaf joint frame, default (0, 1, 0)).

K3 — replaces trajoptmpcreference_tpu/ops/kinematics.py
``_pallas_task_vec`` (kernels/csrc/task_vec.cu): the task residual
[ee_pos_k(q); J(q) qd], k = min(3, n).  Latency bounds it, not its bytes
(2n values in, 2k out per lane) or its operations: below one wave of
blocks its time is the launch plus one lane's dependent chain.  So it
runs one thread per lane with the robot's constants copied into shared
memory once per block (no load from device memory inside the chain), the
joints unrolled so that each joint's sin / cos stays in registers (no
stack beyond libm's sincos), (rotation, origin) pairs composed instead of
4x4 products, and J qd summed down the chain as it goes.  A group of
threads per lane issued more instructions a lane than it saved.  Nothing
on the solver path differentiates through ``task_vec`` (the cost's
gradient and Gauss-Newton Hessian use ``jacobian_tot_state`` explicitly),
so the kernel needs no autograd.Function.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from trajoptmpcreference_tpu_torch.models.robot import REVOLUTE, RobotModel
from trajoptmpcreference_tpu_torch.ops import lanes as _lanes
from trajoptmpcreference_tpu_torch.ops import spatial
from trajoptmpcreference_tpu_torch.ops.lanes import (
    check_lanes,
    from_lanes,
    kinematic_chain,
    launch,
    pack_robot,
    to_lanes,
)


def _kin_consts(robot: RobotModel, offset, in_chain, order, is_rev, dtype,
                device) -> dict:
    """Constant tensors of the kinematics on one device (built once: a
    pageable host-to-device copy inside a solve would wait for the stream)."""
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    axes = np.asarray(robot.axis)
    A = np.stack([np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]],
                            [-a[1], a[0], 0]]) for a in axes])
    Ef = np.asarray(robot.E_fixed)
    return dict(Ef=t(Ef), tf=t(robot.t_fixed), axis=t(axes), A=t(A),
                A2=t(A @ A),
                Ef_ax=t(np.einsum("jki,jk->ji", Ef, axes)),
                off=t([*offset, 1.0]), eye3=t(np.eye(3)), eye4=t(np.eye(4)),
                in_chain=torch.as_tensor(in_chain, device=device),
                order=torch.as_tensor(order, device=device),
                is_rev=torch.as_tensor(is_rev, device=device),
                le=torch.as_tensor(order[None, :] <= order[:, None],
                                   device=device),
                both_in_chain=torch.as_tensor(in_chain[:, None]
                                              & in_chain[None, :],
                                              device=device))


def _joint_hom_lanes(robot: RobotModel, j: int, theta, C: dict):
    """Homogeneous transform for a lane vector theta (L,) -> (4, 4, L)."""
    H = theta.new_zeros((4, 4, theta.shape[0]))
    H[3, 3] = 1.0
    if robot.joint_type[j] == REVOLUTE:
        st, ct = torch.sin(theta), 1.0 - torch.cos(theta)
        E = (C["eye3"][:, :, None] - st * C["A"][j][:, :, None]
             + ct * C["A2"][j][:, :, None])
        REf = (E[:, :, None, :] * C["Ef"][j][None, :, :, None]).sum(1)  # E @ Ef
        H[:3, :3] = REf.transpose(0, 1)
        H[:3, 3] = C["tf"][j][:, None]
    else:
        H[:3, :3] = C["Ef"][j].T[:, :, None]
        H[:3, 3] = C["axis"][j][:, None] * theta + C["tf"][j][:, None]
    return H


def task_vec_kernel(packed: torch.Tensor, n: int, q, qd):
    """K3 on the card: (n, L), (n, L) -> (2k, L)."""
    L = check_lanes(n, packed, q, qd)
    k = min(3, n)
    out = torch.empty((2 * k, L), dtype=q.dtype, device=q.device)
    if L:
        launch("task_vec", n, packed, out, q, qd)
        task_vec_kernel.launches += 1
    return out


task_vec_kernel.launches = 0


class _Chain:
    """The end-effector chain of one robot (point ``offset`` in the leaf
    joint's frame, leaf ``leaf``) and the per-(device, dtype) constants."""

    def __init__(self, robot: RobotModel,
                 offset: Tuple[float, float, float] = (0.0, 1.0, 0.0),
                 leaf: int = 0):
        n = robot.n
        self.robot = robot
        self.offset = tuple(float(o) for o in offset)
        self.leaf = leaf
        self.k = min(3, n)
        self.chain = kinematic_chain(robot, leaf)
        in_chain = np.zeros(n, dtype=bool)
        in_chain[np.array(self.chain)] = True
        order = np.full(n, -1)
        for pos, j in enumerate(self.chain):
            order[j] = pos
        self._in_chain = in_chain
        self._order = order
        self._is_rev = np.array([robot.joint_type[j] == REVOLUTE
                                 for j in range(n)])
        self._consts = {}

    def consts(self, like: torch.Tensor) -> dict:
        key = (like.device, like.dtype)
        if key not in self._consts:
            self._consts[key] = _kin_consts(
                self.robot, self.offset, self._in_chain, self._order,
                self._is_rev, like.dtype, like.device)
        return self._consts[key]


class Kinematics(_Chain):
    """Per-sample kinematics (JAX ``make_kinematics(use_lanes=False)``):
    q, qd (..., n) with any leading batch dimensions.  Every function is
    free of writes into tensors that derive from q, so torch.func can
    differentiate it (``d2jdq2`` does; so does UrdfCost's exact Hessian)."""

    @property
    def plain(self) -> "Kinematics":
        """The autodiff-safe variant: itself (JAX ``Kinematics.plain``)."""
        return self

    def frames(self, q):
        """World end-effector point p (..., 3), world joint axes w
        (..., n, 3) and origins o (..., n, 3); joints off the chain are 0."""
        robot = self.robot
        C = self.consts(q)
        batch = q.shape[:-1]
        H = C["eye4"]
        zero = q.new_zeros(batch + (3,))
        w, o = [zero] * robot.n, [zero] * robot.n
        for j in self.chain:
            # world axis: the rotation up to and including this joint's
            # fixed frame; the joint turns about its (fixed-frame) axis
            w[j] = ((H[..., :3, :3] @ C["Ef"][j].T) @ C["axis"][j]).expand(
                batch + (3,))
            Hj = spatial._hom(robot.joint_type[j], C["eye3"], C["A"][j],
                              C["A2"][j], C["Ef"][j], C["tf"][j],
                              C["axis"][j], C["eye4"][3], q[..., j])
            H = H @ Hj
            # the child frame's origin lies on the joint axis: the point a
            # revolute Jacobian column pivots about
            o[j] = H[..., :3, 3]
        p = (H @ C["off"])[..., :3]
        return p, torch.stack(w, dim=-2), torch.stack(o, dim=-2)

    def _jac(self, p, w, o):
        """(..., n, 3) Jacobian columns (zero off the chain)."""
        C = self.consts(p)
        Jrev = torch.linalg.cross(w, p[..., None, :] - o, dim=-1)
        J = torch.where(C["is_rev"][:, None], Jrev, w)
        return torch.where(C["in_chain"][:, None], J, 0.0)

    def ee_pos_xyz(self, q):
        """World end-effector point (..., 3)."""
        return self.frames(q)[0]

    def ee_pos(self, q):
        """The planar slice (..., 2) (ref: RBDReference.py:134,147)."""
        return self.ee_pos_xyz(q)[..., :2]

    def jacobian(self, q):
        """The first k = min(3, n) rows of d(xyz)/dq, (..., k, n)."""
        return self._jac(*self.frames(q)).transpose(-1, -2)[..., :self.k, :]

    def _djdq(self, p, w, o):
        C = self.consts(p)
        rel = p[..., None, :] - o                            # (..., n, 3)
        Jf = self._jac(p, w, o)
        cx = lambda a, b: torch.linalg.cross(a, b, dim=-1)
        wl = w[..., None, :, :]                              # [j, l]: w_l
        wj = w[..., :, None, :]                              # w_j
        relj = rel[..., :, None, :]                          # p - o_j
        # l <= j, both revolute / prismatic j (revolute l) / l > j
        dJ_le = cx(cx(wl, wj), relj) + cx(wj, cx(wl, relj))
        dJ_gt = cx(wj, Jf[..., None, :, :])
        rev = C["is_rev"]
        dJ_le = torch.where(rev[:, None, None], dJ_le, cx(wl, wj)) * rev[None, :, None]
        dJ_gt = torch.where(rev[:, None, None], dJ_gt, 0.0)
        dJ = torch.where(C["le"][:, :, None], dJ_le, dJ_gt)  # (..., j, l, 3)
        dJ = torch.where(C["both_in_chain"][:, :, None], dJ, 0.0)
        return dJ.movedim(-1, -3)[..., :self.k, :, :]

    def djdq(self, q):
        """dJ[i, j]/dq_l as (..., k, n, n) from the geometric recursions."""
        return self._djdq(*self.frames(q))

    def d2jdq2(self, q):
        """d2J[i, j]/dq_l dq_m as (..., k, n, n, n): torch.func.jacfwd of
        djdq, one sample at a time (JAX ``jax.jacfwd(djdq)``)."""
        n = self.robot.n
        out = torch.func.vmap(torch.func.jacfwd(self.djdq))(q.reshape(-1, n))
        return out.reshape(q.shape[:-1] + out.shape[1:])

    def jacobian_tot_state(self, q, qd):
        """d [ee_pos_k; J qd] / d [q; qd] = [[J, 0], [dJ/dq . qd, J]],
        (..., 2k, 2n) (ref: RBDReference.py:318-336), from one frames pass."""
        frames = self.frames(q)
        J = self._jac(*frames).transpose(-1, -2)[..., :self.k, :]
        J2 = (self._djdq(*frames) @ qd[..., None, :, None])[..., 0]
        top = torch.cat([J, torch.zeros_like(J)], dim=-1)
        bot = torch.cat([J2, J], dim=-1)
        return torch.cat([top, bot], dim=-2)

    def task_vec(self, q, qd):
        """[ee_pos_k; J qd] (..., 2k) from one frames pass (the task-space
        cost's residual before the goal shift)."""
        p, w, o = self.frames(q)
        J = self._jac(p, w, o).transpose(-1, -2)[..., :self.k, :]
        return torch.cat([p[..., :self.k], (J @ qd[..., None])[..., 0]], dim=-1)

    # state-level methods shared with LaneKinematics
    def task_vec_x(self, x):
        n = self.robot.n
        return self.task_vec(x[..., :n], x[..., n:])

    def jacobian_tot_state_x(self, x):
        n = self.robot.n
        return self.jacobian_tot_state(x[..., :n], x[..., n:])

    def jacobian_x(self, x):
        return self.jacobian(x[..., :self.robot.n])

    def ee_pos_x(self, x):
        return self.ee_pos(x[..., :self.robot.n])


class LaneKinematics(_Chain):
    """Lanes kinematics for one robot, end-effector point and leaf; K3 on
    the card.  ``plain`` is the per-sample Kinematics of the same chain
    (JAX ``dataclasses.replace(plain, ...)``): what autodiff takes."""

    def __init__(self, robot: RobotModel,
                 offset: Tuple[float, float, float] = (0.0, 1.0, 0.0),
                 leaf: int = 0, use_kernel_task: bool = True):
        super().__init__(robot, offset, leaf)
        self.use_kernel_task = use_kernel_task
        self.plain = Kinematics(robot, offset, leaf)
        self._packed = {}

    def frames_L(self, q):
        """q (n, L) -> p (3, L), w (n, 3, L), o (n, 3, L)."""
        robot = self.robot
        C = self.consts(q)
        L = q.shape[1]
        H = C["eye4"][:, :, None].expand(4, 4, L)
        w_list = [q.new_zeros((3, L))] * robot.n
        o_list = [q.new_zeros((3, L))] * robot.n
        for j in self.chain:
            w_list[j] = (H[:3, :3] * C["Ef_ax"][j][None, :, None]).sum(1)
            Hj = _joint_hom_lanes(robot, j, q[j], C)
            H = (H[:, :, None, :] * Hj[None]).sum(1)
            o_list[j] = H[:3, 3]
        p = (H[:3] * C["off"][None, :, None]).sum(1)
        return p, torch.stack(w_list), torch.stack(o_list)

    def _jac_from_frames(self, p, w, o):
        """(n, 3, L) Jacobian columns (zero off the chain)."""
        C = self.consts(p)
        rel = p[None] - o
        Jrev = torch.linalg.cross(w, rel, dim=1)
        J = torch.where(C["is_rev"][:, None, None], Jrev, w)
        return torch.where(C["in_chain"][:, None, None], J, torch.zeros_like(J))

    def ee_pos_xyz(self, q):
        """World end-effector point (3, L)."""
        return self.frames_L(q)[0]

    def ee_pos(self, q):
        """The planar slice (2, L)."""
        return self.ee_pos_xyz(q)[:2]

    def jac_full_L(self, q):
        """d(xyz)/dq (3, n, L)."""
        return self._jac_from_frames(*self.frames_L(q)).transpose(0, 1)

    def jacobian(self, q):
        """(k, n, L)."""
        return self.jac_full_L(q)[:self.k]

    def djdq_L(self, q, frames=None):
        """dJ[i, j]/dq_l as (k, j, l, L); ``frames`` reuses a frames_L pass."""
        p, w, o = self.frames_L(q) if frames is None else frames
        C = self.consts(q)
        rel = p[None] - o
        Jf = self._jac_from_frames(p, w, o)                  # (n, 3, L)
        cx = lambda a, b: torch.linalg.cross(a, b, dim=2)
        n = w.shape[0]
        wl_b = w[None].expand(n, n, 3, -1)                   # [j, l, 3, L]: w_l
        wj_b = w[:, None].expand(n, n, 3, -1)                # w_j
        relj_b = rel[:, None].expand(n, n, 3, -1)            # p - o_j
        dJ_le = cx(cx(wl_b, wj_b), relj_b) + cx(wj_b, cx(wl_b, relj_b))
        dJ_gt = cx(wj_b, Jf[None].expand(n, n, 3, -1))
        rev = C["is_rev"]
        rev_j = rev[:, None, None, None]
        rev_l = rev[None, :, None, None]
        zero = torch.zeros_like(dJ_le)
        dJ_le_full = torch.where(rev_j, dJ_le, cx(wl_b, wj_b)) * rev_l
        dJ_gt_full = torch.where(rev_j, dJ_gt, zero)
        ordv = C["order"]
        le = (ordv[None, :] <= ordv[:, None])[:, :, None, None]
        dJ = torch.where(le, dJ_le_full, dJ_gt_full)         # (j, l, 3, L)
        chain = C["in_chain"]
        mask = chain[:, None, None, None] & chain[None, :, None, None]
        dJ = torch.where(mask, dJ, zero)
        return dJ.permute(2, 0, 1, 3)[:self.k]

    def jacobian_tot_state(self, q, qd):
        """d [ee_pos_k; J qd] / d [q; qd] = [[J, 0], [dJ/dq . qd, J]]
        -> (2k, 2n, L) (kinematics.py ``jt_L``), from one frames pass."""
        frames = self.frames_L(q)
        J = self._jac_from_frames(*frames).transpose(0, 1)[:self.k]  # (k, n, L)
        dJ = self.djdq_L(q, frames)                          # (k, n, n, L)
        J2 = (dJ * qd[None, None]).sum(2)
        top = torch.cat([J, torch.zeros_like(J)], dim=1)
        bot = torch.cat([J2, J], dim=1)
        return torch.cat([top, bot], dim=0)

    def task_vec_L(self, q, qd):
        """Plain version of K3: [ee_pos_k; J qd] (2k, L), one frames pass."""
        p, w, o = self.frames_L(q)
        J = self._jac_from_frames(p, w, o)                   # (n, 3, L)
        vel = (J[:, :self.k] * qd[:, None]).sum(0)
        return torch.cat([p[:self.k], vel], dim=0)

    def packed(self, like: torch.Tensor) -> torch.Tensor:
        key = (like.device, like.dtype)
        if key not in self._packed:
            self._packed[key] = pack_robot(self.robot, like.dtype, like.device,
                                           offset=self.offset, leaf=self.leaf)
        return self._packed[key]

    def task_vec(self, q, qd):
        """Dispatch: K3 for CUDA tensors (unless use_kernel_task is off),
        the plain version for CPU tensors."""
        if _lanes.on_card(q) and self.use_kernel_task:
            return task_vec_kernel(self.packed(q), self.robot.n, q, qd)
        return self.task_vec_L(q, qd)

    # state-level methods shared with Kinematics: x (..., 2n) onto the
    # lane axis and back
    def task_vec_x(self, x):
        """[ee_pos_k; J qd] (..., 2k): K3 on the card."""
        n = self.robot.n
        return from_lanes(self.task_vec(to_lanes(x, 0, n), to_lanes(x, n, 2 * n)),
                          x.shape[:-1])

    def jacobian_tot_state_x(self, x):
        """(..., 2k, 2n)."""
        n = self.robot.n
        return from_lanes(self.jacobian_tot_state(to_lanes(x, 0, n),
                                                  to_lanes(x, n, 2 * n)),
                          x.shape[:-1])

    def jacobian_x(self, x):
        """(..., k, n)."""
        return from_lanes(self.jacobian(to_lanes(x, 0, self.robot.n)),
                          x.shape[:-1])

    def ee_pos_x(self, x):
        """(..., 2)."""
        return from_lanes(self.ee_pos(to_lanes(x, 0, self.robot.n)),
                          x.shape[:-1])


def make_kinematics(robot: RobotModel,
                    offset: Tuple[float, float, float] = (0.0, 1.0, 0.0),
                    leaf: int = 0, use_lanes: bool = False,
                    use_kernel_task: bool = True):
    """The per-sample ``Kinematics`` of the chain (JAX make_kinematics'
    default), or with ``use_lanes`` its ``LaneKinematics`` (K3 on the card
    unless ``use_kernel_task`` is off)."""
    if use_lanes:
        return LaneKinematics(robot, offset, leaf, use_kernel_task)
    return Kinematics(robot, offset, leaf)
