"""Batch-minor ("lanes") rigid-body dynamics, and kernels K1 and K2.

Port of trajoptmpcreference_tpu/ops/lanes.py.  Every quantity carries the
batch as its TRAILING axis — (6, L), (6, 6, L), (n, 3n, L) — exactly the JAX
package's lanes layout, so neighbouring CUDA threads read neighbouring
lanes (scenario x knot) and the tests compare like with like.

Two layers live here:

* the plain PyTorch versions ``fd_lanes`` / ``fd_grad_lanes`` (and their
  RNEA / analytic-Minv / dRNEA building blocks), written as broadcast-sums
  over the lane axis like the JAX code;
* the wrappers of the hand-written CUDA kernels K1 (``fd_grad_kernel``)
  and K2 (``fd_kernel``) with their launch counters, and the dispatch in
  ``LaneDynamics.fd`` / ``fd_grad``: a CPU tensor goes to the plain
  version; a CUDA tensor goes to the kernel (or raises) unless the plant's
  kernel flag is off, an explicit choice of the plain version.

K1 — replaces trajoptmpcreference_tpu/ops/lanes.py ``_pallas_fd_grad``
(kernels/csrc/fd_grad.cu): K2's recursion, then a second RNEA with qdd, the
dRNEA and -Minv D.  Its operations bound it.  It runs K2's thread group per
lane (kernels/csrc/fd_group.cuh), then the gradient on the same group, one
dRNEA derivative column per thread in registers.

K2 — replaces ``_pallas_fd`` (kernels/csrc/fd.cu): RNEA + Minv + the qdd
contraction per lane.  Its traffic is 3n values in and n out per lane; its
operations bound it.  A group of threads shares each lane's recursion,
several lanes per block: each Minv column lives in its own thread's
registers, the rest of the state in shared memory.

Both keep a block's lanes in shared memory; ``smem_bytes`` is a block's
size, from the kernel's own formula (``tmr_<name>_smem_elems``), and
``check_fits`` refuses a block over the limit.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List

import numpy as np
import torch

from trajoptmpcreference_tpu_torch.models.robot import REVOLUTE, RobotModel


# ---------------------------------------------------------------- helpers
def _mm(M, A):
    """(6, 6, L) @ (6, k, L) -> (6, k, L), or @ (6, L) -> (6, L)."""
    if A.dim() == 2:
        return (M * A[None]).sum(1)
    return (M[:, :, None, :] * A[None]).sum(1)


def _mmTv(M, v):
    """M^T v: (6, 6, L)^T @ (6, L) -> (6, L)."""
    return (M * v[:, None, :]).sum(0)


def _mmTm(M, A):
    """M^T A: (6, 6, L)^T @ (6, k, L) -> (6, k, L)."""
    return (M[:, :, None, :] * A[:, None, :, :]).sum(0)


def _sm(Ms, A):
    """Constant (6, 6) @ (6, k, L)."""
    return (Ms[:, :, None, None] * A[None]).sum(1)


def _crm_v(a, b):
    """crm(a) @ b for spatial vectors stacked on dim 0 (broadcasting)."""
    return torch.stack([
        -a[2] * b[1] + a[1] * b[2],
        a[2] * b[0] - a[0] * b[2],
        -a[1] * b[0] + a[0] * b[1],
        -a[2] * b[4] + a[1] * b[5] - a[5] * b[1] + a[4] * b[2],
        a[2] * b[3] - a[0] * b[5] + a[5] * b[0] - a[3] * b[2],
        -a[1] * b[3] + a[0] * b[4] - a[4] * b[0] + a[3] * b[1],
    ])


def _crf_v(a, b):
    """crf(a) @ b = -crm(a)^T b."""
    return torch.stack([
        -a[2] * b[1] + a[1] * b[2] - a[5] * b[4] + a[4] * b[5],
        a[2] * b[0] - a[0] * b[2] + a[5] * b[3] - a[3] * b[5],
        -a[1] * b[0] + a[0] * b[1] - a[4] * b[3] + a[3] * b[4],
        -a[2] * b[4] + a[1] * b[5],
        a[2] * b[3] - a[0] * b[5],
        -a[1] * b[3] + a[0] * b[4],
    ])


def _icrf(v):
    """icrf(v) as (6, 6, L): icrf(f) m = crf(m) f."""
    z = torch.zeros_like(v[0])
    r = [[z, v[2], -v[1], z, v[5], -v[4]],
         [-v[2], z, v[0], -v[5], z, v[3]],
         [v[1], -v[0], z, v[4], -v[3], z],
         [z, v[5], -v[4], z, z, z],
         [-v[5], z, v[3], z, z, z],
         [v[4], -v[3], z, z, z, z]]
    return torch.stack([torch.stack(row) for row in r])


def _crf_m(v, A):
    """crf(v) @ A with v (6, L), A (6, k, L)."""
    return _crf_v(v[:, None, :], A)


@dataclasses.dataclass(frozen=True)
class LaneConsts:
    """Per-robot constant tensors (lanes.py LaneConsts)."""

    S: torch.Tensor        # (n, 6)
    I6: torch.Tensor       # (n, 6, 6)
    Xf: torch.Tensor       # (n, 6, 6)
    A: torch.Tensor        # (n, 3, 3) axis skews
    A2: torch.Tensor       # (n, 3, 3)
    crmS: torch.Tensor     # (n, 6, 6)
    damping: torch.Tensor  # (n,)


def _skew(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]],
                    dtype=np.float64)


def lane_consts(robot: RobotModel, dtype, device=None) -> LaneConsts:
    n = robot.n
    A = np.zeros((n, 3, 3))
    crmS = np.zeros((n, 6, 6))
    for j in range(n):
        A[j] = _skew(np.asarray(robot.axis[j]))
        s = np.asarray(robot.S[j])
        crmS[j, :3, :3] = _skew(s[:3])
        crmS[j, 3:, 3:] = crmS[j, :3, :3]
        crmS[j, 3:, :3] = _skew(s[3:])
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    return LaneConsts(S=t(robot.S), I6=t(robot.I_spatial), Xf=t(robot.X_fixed),
                      A=t(A), A2=t(A @ A), crmS=t(crmS), damping=t(robot.damping))


# Packed robot buffer read by the CUDA kernels (kernels/csrc/lanes_common.cuh
# holds the same offsets): a header [gravity, ee offset xyz], then one
# JOINT_STRIDE block per joint.
HEADER = 4
JOINT_STRIDE = 128
_OFF = dict(S=0, I6=6, XF=42, AX=78, A2=87, DAMP=96, JTYPE=97, PARENT=98,
            EF=99, TF=108, AXIS=111, EFAX=114, CHAIN=117)


def to_lanes(x, k0: int, k1: int):
    """Columns k0:k1 of x (..., d) as a contiguous (k1-k0, L) lanes tensor."""
    return x.reshape(-1, x.shape[-1])[:, k0:k1].T.contiguous()


def from_lanes(y, lead):
    """(d, L) or (d0, d1, L) lanes tensor -> (*lead, d) or (*lead, d0, d1)."""
    return y.movedim(-1, 0).reshape(*lead, *y.shape[:-1])


def kinematic_chain(robot: RobotModel, leaf: int = 0) -> List[int]:
    """Joint ids from the base to the end-effector leaf, in chain order
    (ops/kinematics.py make_kinematics)."""
    leaf_id = robot.leaves[leaf]
    return list(robot.ancestors(leaf_id)) + [leaf_id]


def pack_robot(robot: RobotModel, dtype, device, gravity: float = -9.81,
               offset=(0.0, 1.0, 0.0), leaf: int = 0) -> torch.Tensor:
    """One flat constant buffer per robot for K1, K2 and K3."""
    n = robot.n
    buf = np.zeros(HEADER + n * JOINT_STRIDE)
    buf[0] = gravity
    buf[1:4] = offset
    chain = set(kinematic_chain(robot, leaf))
    S = robot.S
    for j in range(n):
        o = HEADER + j * JOINT_STRIDE
        ax = np.asarray(robot.axis[j])
        A = _skew(ax)
        put = lambda key, vals: buf.__setitem__(
            slice(o + _OFF[key], o + _OFF[key] + np.size(vals)),
            np.ravel(vals))
        put("S", S[j])
        put("I6", robot.I_spatial[j])
        put("XF", robot.X_fixed[j])
        put("AX", A)
        put("A2", A @ A)
        put("DAMP", robot.damping[j])
        put("JTYPE", robot.joint_type[j])
        put("PARENT", robot.parent[j])
        put("EF", robot.E_fixed[j])
        put("TF", robot.t_fixed[j])
        put("AXIS", ax)
        put("EFAX", np.asarray(robot.E_fixed[j]).T @ ax)
        put("CHAIN", float(j in chain))
    return torch.as_tensor(buf, dtype=dtype, device=device)


def _joint_X(robot, j, theta, C: LaneConsts):
    """Spatial transform X_j(theta) for a lane vector theta (L,) -> (6,6,L)."""
    L = theta.shape[0]
    I3 = torch.eye(3, dtype=theta.dtype, device=theta.device)[:, :, None]
    Xfree = theta.new_zeros((6, 6, L))
    if robot.joint_type[j] == REVOLUTE:
        st, ct = torch.sin(theta), 1.0 - torch.cos(theta)
        E = I3 - st * C.A[j][:, :, None] + ct * C.A2[j][:, :, None]
        Xfree[:3, :3] = E
        Xfree[3:, 3:] = E
    else:
        Xfree[:3, :3] = I3
        Xfree[3:, 3:] = I3
        Xfree[3:, :3] = -C.A[j][:, :, None] * theta
    return (Xfree[:, :, None, :] * C.Xf[j][None, :, :, None]).sum(1)


def _gvec(gravity, L, like):
    """Gravity spatial vector (6, L) = -g on row 5."""
    g = like.new_zeros((6, L))
    g[5] = -gravity
    return g


# ------------------------------------------------------------- algorithms
def _rnea_lanes(robot, X, qd, qdd, gravity, C: LaneConsts):
    """RNEA over lanes; returns (c (n, L), v, a, f_acc lists)."""
    n = robot.n
    L = qd.shape[1]
    g = _gvec(gravity, L, qd)
    v, a, f = [], [], []
    for i in range(n):
        Si = C.S[i][:, None]
        p = robot.parent[i]
        if p == -1:
            vi = Si * qd[i]
            ai = _mm(X[i], g)
        else:
            vi = _mm(X[i], v[p]) + Si * qd[i]
            ai = _mm(X[i], a[p])
        ai = ai + qd[i] * _crm_v(vi, Si.expand_as(vi))
        if qdd is not None:
            ai = ai + Si * qdd[i]
        Iv = (C.I6[i][:, :, None] * vi[None]).sum(1)
        Ia = (C.I6[i][:, :, None] * ai[None]).sum(1)
        v.append(vi)
        a.append(ai)
        f.append(Ia + _crf_v(vi, Iv))
    f_acc = list(f)
    c = [None] * n
    for i in range(n - 1, -1, -1):
        c[i] = (C.S[i][:, None] * f_acc[i]).sum(0)
        p = robot.parent[i]
        if p != -1:
            f_acc[p] = f_acc[p] + _mmTv(X[i], f_acc[i])
    return torch.stack(c), v, a, f_acc


def _minv_lanes(robot, X, C: LaneConsts):
    """Analytic Minv over lanes (ref: RBDReference.py:805-930) -> (n, n, L).

    Row i is nonzero only on columns >= i (DFS numbering makes every
    subtree the contiguous range i..i+size-1), so each row is written
    over columns i.. and the upper triangle is mirrored at the end."""
    n = robot.n
    L = X[0].shape[-1]
    dt, dev = X[0].dtype, X[0].device
    IA = [C.I6[i][:, :, None].expand(6, 6, L) for i in range(n)]
    Minv = torch.zeros((n, n, L), dtype=dt, device=dev)
    F = [torch.zeros((6, n, L), dtype=dt, device=dev) for _ in range(n)]
    U = [None] * n
    Dinv = [None] * n
    for i in range(n - 1, -1, -1):
        Si = C.S[i]
        U[i] = (Si[None, :, None] * IA[i]).sum(1)                 # (6, L)
        Dinv[i] = 1.0 / (Si[:, None] * U[i]).sum(0)               # (L,)
        SF = (Si[:, None, None] * F[i][:, i:, :]).sum(0)          # (n-i, L)
        Minv[i, i:] = -Dinv[i] * SF
        Minv[i, i] = Minv[i, i] + Dinv[i]
        p = robot.parent[i]
        if p != -1:
            F[i] = F[i] + U[i][:, None, :] * Minv[i][None]
            F[p] = F[p] + _mmTm(X[i], F[i])
            Ia = IA[i] - U[i][:, None, :] * (Dinv[i] * U[i][None])
            IA[p] = IA[p] + _mmTm(X[i], _mm(Ia, X[i]))
    for i in range(n):
        Si = C.S[i]
        p = robot.parent[i]
        if p != -1:
            UX = (U[i][:, None, :] * X[i]).sum(0)                 # (6, L)
            contrib = (UX[:, None, :] * F[p][:, i:, :]).sum(0)
            Minv[i, i:] = Minv[i, i:] - Dinv[i] * contrib
        Fi = Si[:, None, None] * Minv[i, i:][None]
        if p != -1:
            Fi = Fi + _mm(X[i], F[p][:, i:, :])
        F[i] = torch.cat([F[i][:, :i], Fi], dim=1)
    upper = torch.triu(torch.ones(n, n, dtype=dt, device=dev))[:, :, None] * Minv
    strict = torch.triu(torch.ones(n, n, dtype=dt, device=dev), 1)[:, :, None]
    return upper + (strict * upper).transpose(0, 1)


def _rnea_grad_lanes(robot, X, qd, gravity, v, a, f_acc, C: LaneConsts):
    """Analytic d tau / d [q, qd] over lanes -> (n, 2n, L)
    (ops/rbd.py rnea_grad; ref: RBDReference.py:561-802)."""
    n = robot.n
    L = qd.shape[1]
    dt, dev = qd.dtype, qd.device
    g = _gvec(gravity, L, qd)
    zeros = lambda: torch.zeros((6, n, L), dtype=dt, device=dev)
    dv_dq, da_dq, df_dq = [], [], []
    dv_dqd, da_dqd, df_dqd = [], [], []
    for i in range(n):
        SL = C.S[i][:, None].expand(6, L)
        crmS = C.crmS[i]
        p = robot.parent[i]
        if p == -1:
            dv, da, dvd, dad = zeros(), zeros(), zeros(), zeros()
            da[:, i] += _crm_v(_mm(X[i], g), SL)
        else:
            dv = _mm(X[i], dv_dq[p])
            dv[:, i] += _crm_v(_mm(X[i], v[p]), SL)
            da = _mm(X[i], da_dq[p])
            da[:, i] += _crm_v(_mm(X[i], a[p]), SL)
            dvd = _mm(X[i], dv_dqd[p])
            dad = _mm(X[i], da_dqd[p])
        da = da - qd[i] * _sm(crmS, dv)
        dvd[:, i] += SL
        dad = dad - qd[i] * _sm(crmS, dvd)
        dad[:, i] += _crm_v(v[i], SL)
        I6 = C.I6[i]
        Iv = (I6[:, :, None] * v[i][None]).sum(1)
        icrfIv = _icrf(Iv)
        df = _sm(I6, da) + _mm(icrfIv, dv) + _crf_m(v[i], _sm(I6, dv))
        dfd = _sm(I6, dad) + _mm(icrfIv, dvd) + _crf_m(v[i], _sm(I6, dvd))
        dv_dq.append(dv)
        da_dq.append(da)
        df_dq.append(df)
        dv_dqd.append(dvd)
        da_dqd.append(dad)
        df_dqd.append(dfd)
    dc_dq = [None] * n
    dc_dqd = [None] * n
    for i in range(n - 1, -1, -1):
        Si = C.S[i][:, None, None]
        dc_dq[i] = (Si * df_dq[i]).sum(0)                         # (n, L)
        dc_dqd[i] = (Si * df_dqd[i]).sum(0)
        p = robot.parent[i]
        if p != -1:
            upd = _mmTm(X[i], df_dq[i])
            # fxS = crf(S) f (ops/spatial.fxS); the reference's -crm(f) S
            # shortcut is revolute-only — see spatial.py fxS docstring
            fxS = _crf_v(C.S[i][:, None].expand(6, L), f_acc[i])
            upd[:, i] += _mmTv(X[i], fxS)
            df_dq[p] = df_dq[p] + upd
            df_dqd[p] = df_dqd[p] + _mmTm(X[i], df_dqd[i])
    out_q = torch.stack(dc_dq)
    out_qd = torch.stack(dc_dqd)
    if np.any(robot.damping):
        out_qd = out_qd + torch.diag(C.damping)[:, :, None]
    return torch.cat([out_q, out_qd], dim=1)


def fd_lanes(robot: RobotModel, q, qd, u, gravity=-9.81, consts=None):
    """Plain version of K2: qdd = Minv (u - c) over lanes; (n, L) -> (n, L)."""
    C = lane_consts(robot, q.dtype, q.device) if consts is None else consts
    X = [_joint_X(robot, j, q[j], C) for j in range(robot.n)]
    c, _, _, _ = _rnea_lanes(robot, X, qd, None, gravity, C)
    Mi = _minv_lanes(robot, X, C)
    return (Mi * (u - c)[None]).sum(1)


def fd_grad_lanes(robot: RobotModel, q, qd, u, gravity=-9.81, consts=None):
    """Plain version of K1: dqdd/d[q, qd, u] over lanes -> (n, 3n, L)."""
    C = lane_consts(robot, q.dtype, q.device) if consts is None else consts
    X = [_joint_X(robot, j, q[j], C) for j in range(robot.n)]
    c, _, _, _ = _rnea_lanes(robot, X, qd, None, gravity, C)
    Mi = _minv_lanes(robot, X, C)
    qdd = (Mi * (u - c)[None]).sum(1)
    # rerun RNEA WITH qdd for the gradient's (v, a, f_acc)
    _, v2, a2, facc2 = _rnea_lanes(robot, X, qd, qdd, gravity, C)
    dtau = _rnea_grad_lanes(robot, X, qd, gravity, v2, a2, facc2, C)
    dfx = -(Mi[:, :, None, :] * dtau[None]).sum(1)
    return torch.cat([dfx, Mi], dim=1)


# ---------------------------------------------------------------- kernels
MAX_KERNEL_DOF = 7


def on_card(t: torch.Tensor) -> bool:
    """True when ``t`` lies on a CUDA device: the kernels' route."""
    return t.device.type == "cuda"


def check_lanes(n: int, packed: torch.Tensor, *arrays) -> int:
    """Validate kernel operands: CUDA, one dtype (f32/f64), contiguous,
    (n, L) each; returns L."""
    if not 1 <= n <= MAX_KERNEL_DOF:
        raise ValueError(f"the CUDA kernels are built for 1..{MAX_KERNEL_DOF} "
                         f"joints, got n={n}")
    ref = arrays[0]
    if ref.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"kernel dtype must be float32 or float64, got {ref.dtype}")
    if ref.dim() != 2 or ref.shape[0] != n:
        raise ValueError(f"expected an (n={n}, L) lanes tensor, got {tuple(ref.shape)}")
    for t in arrays + (packed,):
        if t.device != ref.device or not on_card(t):
            raise ValueError("kernel operands must all lie on one CUDA device")
        if t.dtype != ref.dtype:
            raise TypeError("kernel operands must share one dtype")
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
    for t in arrays[1:]:
        if t.shape != ref.shape:
            raise ValueError(f"shape mismatch {tuple(t.shape)} vs {tuple(ref.shape)}")
    if packed.numel() != HEADER + n * JOINT_STRIDE:
        raise ValueError("packed robot buffer does not match n")
    return ref.shape[1]


def launch(lib_name: str, n: int, packed, out, q, qd, u=None) -> None:
    """Call one kernel library entry on the current stream; raise on a
    nonzero cudaError."""
    from trajoptmpcreference_tpu_torch.kernels import _build
    suffix = "f32" if q.dtype == torch.float32 else "f64"
    fn = getattr(_build.library(lib_name), f"tmr_{lib_name}_{suffix}")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(qd.data_ptr()),
            ctypes.c_void_p(None if u is None else u.data_ptr()),
            ctypes.c_void_p(packed.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            ctypes.c_int(n), ctypes.c_int(q.shape[1]), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {lib_name} failed: cudaError {rc}")


# the opt-in shared memory of one thread block on Hopper (227 KB)
SMEM_LIMIT = 232_448
_KERNEL_ID = {"fd": "K2", "fd_grad": "K1"}


def smem_bytes(lib_name: str, n: int, dtype: torch.dtype,
               smem_elems=None) -> int:
    """Dynamic shared memory of one block of kernel ``lib_name`` (fd or
    fd_grad): the kernel's own formula, ``tmr_<lib_name>_smem_elems``
    (values per block), from the built library unless another build's
    entry is given."""
    if smem_elems is None:
        from trajoptmpcreference_tpu_torch.kernels import _build
        smem_elems = getattr(_build.library(lib_name),
                             f"tmr_{lib_name}_smem_elems")
    return dtype.itemsize * int(smem_elems(n))


def check_fits(lib_name: str, n: int, dtype: torch.dtype,
               smem_elems=None) -> None:
    """Raise ValueError when a block of kernel ``lib_name`` for n joints
    does not fit the shared memory of one thread block."""
    need = smem_bytes(lib_name, n, dtype, smem_elems)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"{_KERNEL_ID[lib_name]} keeps a block's lanes in shared memory: "
            f"n={n} in {dtype} needs {need} bytes, over the {SMEM_LIMIT}-byte "
            "limit of one thread block")


def fd_kernel(packed: torch.Tensor, n: int, q, qd, u):
    """K2 on the card: (n, L) x3 -> qdd (n, L)."""
    L = check_lanes(n, packed, q, qd, u)
    check_fits("fd", n, q.dtype)
    out = torch.empty((n, L), dtype=q.dtype, device=q.device)
    if L:
        launch("fd", n, packed, out, q, qd, u)
        fd_kernel.launches += 1
    return out


fd_kernel.launches = 0


def fd_grad_kernel(packed: torch.Tensor, n: int, q, qd, u):
    """K1 on the card: (n, L) x3 -> dqdd/d[q, qd, u] (n, 3n, L)."""
    L = check_lanes(n, packed, q, qd, u)
    check_fits("fd_grad", n, q.dtype)
    out = torch.empty((n, 3 * n, L), dtype=q.dtype, device=q.device)
    if L:
        launch("fd_grad", n, packed, out, q, qd, u)
        fd_grad_kernel.launches += 1
    return out


fd_grad_kernel.launches = 0


class LaneDynamics:
    """fd / fd_grad for one robot over lanes, with per-(device, dtype)
    constant caches.  Dispatch: CPU tensors use the plain versions; CUDA
    tensors use K1 / K2, or the plain versions when the flag is off."""

    def __init__(self, robot: RobotModel, gravity: float = -9.81,
                 use_kernel_fd: bool = True, use_kernel_fd_grad: bool = True):
        self.robot = robot
        self.gravity = gravity
        self.use_kernel_fd = use_kernel_fd
        self.use_kernel_fd_grad = use_kernel_fd_grad
        self._consts = {}
        self._packed = {}

    def consts(self, like: torch.Tensor) -> LaneConsts:
        key = (like.device, like.dtype)
        if key not in self._consts:
            self._consts[key] = lane_consts(self.robot, like.dtype, like.device)
        return self._consts[key]

    def packed(self, like: torch.Tensor) -> torch.Tensor:
        key = (like.device, like.dtype)
        if key not in self._packed:
            self._packed[key] = pack_robot(self.robot, like.dtype, like.device,
                                           gravity=self.gravity)
        return self._packed[key]

    def fd(self, q, qd, u):
        """qdd (n, L)."""
        if on_card(q) and self.use_kernel_fd:
            return fd_kernel(self.packed(q), self.robot.n, q, qd, u)
        return fd_lanes(self.robot, q, qd, u, self.gravity, self.consts(q))

    def fd_grad(self, q, qd, u):
        """dqdd/d[q, qd, u] (n, 3n, L)."""
        if on_card(q) and self.use_kernel_fd_grad:
            return fd_grad_kernel(self.packed(q), self.robot.n, q, qd, u)
        return fd_grad_lanes(self.robot, q, qd, u, self.gravity, self.consts(q))
