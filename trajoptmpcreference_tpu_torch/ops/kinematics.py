"""End-effector kinematics over lanes, and kernel K3.

Port of the lanes forms of trajoptmpcreference_tpu/ops/kinematics.py
(``frames_L``, ``jac_full_L``, ``djdq_L``, ``jt_L``, ``task_vec_L``): every
function takes joint vectors as (n, L) and returns lane-minor tensors.  All
quantities come from ONE forward pass of world-frame transforms via
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
from trajoptmpcreference_tpu_torch.ops.lanes import (
    check_lanes,
    kinematic_chain,
    launch,
    pack_robot,
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
                A2=t(A @ A), Ef_ax=t(np.einsum("jki,jk->ji", Ef, axes)),
                off=t([*offset, 1.0]), eye3=t(np.eye(3)), eye4=t(np.eye(4)),
                in_chain=torch.as_tensor(in_chain, device=device),
                order=torch.as_tensor(order, device=device),
                is_rev=torch.as_tensor(is_rev, device=device))


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


class LaneKinematics:
    """Lanes kinematics for one robot, end-effector point and leaf."""

    def __init__(self, robot: RobotModel,
                 offset: Tuple[float, float, float] = (0.0, 1.0, 0.0),
                 leaf: int = 0, use_kernel_task: bool = True):
        n = robot.n
        self.robot = robot
        self.offset = tuple(float(o) for o in offset)
        self.leaf = leaf
        self.use_kernel_task = use_kernel_task
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
        self._packed = {}

    def consts(self, like: torch.Tensor) -> dict:
        key = (like.device, like.dtype)
        if key not in self._consts:
            self._consts[key] = _kin_consts(
                self.robot, self.offset, self._in_chain, self._order,
                self._is_rev, like.dtype, like.device)
        return self._consts[key]

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
