"""Per-sample rigid-body dynamics over a leading batch.

Port of trajoptmpcreference_tpu/ops/rbd.py: ``make_rbd(robot)`` returns an
``RBD`` bundle of RNEA and its analytical gradient, the analytic inverse
of the joint-space inertia (Carpentier), CRBA, ABA, IDSVA and the forward
dynamics compositions (ref: GRiD/RBDReference/RBDReference.py:399-930,
RBDReference_generalized.py:717-1032).  Every function takes q, qd, qdd,
u as (..., n) with any leading batch dimensions (the JAX functions are
single-sample and vmapped), and the joint recursions are Python loops
over the robot's static n.

These are the formulations the kernels are held against: ABA against
K2's Minv (u - c), IDSVA and CRBA against K1's RNEA gradient and analytic
Minv.  Nothing here reaches a kernel.

The JAX code writes into index subsets (``.at[i, sub].add``); here every
matrix is assembled without writes into a tensor:

* ``minv`` keeps each joint's F (..., 6, n) at full width: outside the
  joint's subtree its columns are exact zeros, so adding them changes
  nothing, and each Minv row is its own tensor until the rows are stacked;
* ``crba`` and ``idsva`` compute each entry once (no entry is written
  twice in the JAX code) and stack them;
* a column added to a (6, n) derivative matrix is a concatenation.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from trajoptmpcreference_tpu_torch.models.robot import RobotModel
from trajoptmpcreference_tpu_torch.ops import spatial
from trajoptmpcreference_tpu_torch.ops.spatial import crf, crm, icrf, mv


@dataclasses.dataclass(frozen=True)
class RBD:
    """Bundle of robot-specialized dynamics functions (batch leading)."""

    robot: RobotModel
    rnea: Callable          # (q, qd, qdd=None, gravity=-9.81, use_damping=False) -> (c, v, a, f)
    rnea_grad: Callable     # (q, qd, qdd, gravity, use_damping) -> dc_du (..., n, 2n)
    minv: Callable          # (q, output_dense=True) -> (..., n, n)
    crba: Callable          # (q,) -> H (..., n, n)
    aba: Callable           # (q, qd, tau, gravity) -> qdd (..., n)
    idsva: Callable         # (q, qd, qdd, gravity) -> (dtau_dq, dtau_dqd)
    fd: Callable            # (q, qd, u, gravity) -> qdd (..., n)
    fd_grad: Callable       # (q, qd, u, gravity) -> dqdd (..., n, 3n)


def _gravity_vec(gravity, like):
    """Fictitious base acceleration: linear z = -gravity
    (ref: RBDReference.py:418-420), (6,)."""
    g = torch.as_tensor(gravity, dtype=like.dtype, device=like.device)
    return torch.cat([g.new_zeros(5), -g.reshape(1)])


def _outer(a, b):
    return a[..., :, None] * b[..., None, :]


def _add_col(M, i, col):
    """M with col added to column i, M (..., r, n), col (..., r)."""
    return torch.cat([M[..., :i], (M[..., i] + col)[..., None], M[..., i + 1:]],
                     dim=-1)


def _stack_entries(entries, n, zero):
    """(..., n, n) from a {(row, col): (...)} map; missing entries are 0."""
    return torch.stack([entries.get((r, c), zero) for r in range(n)
                        for c in range(n)], dim=-1).unflatten(-1, (n, n))


def make_rbd(robot: RobotModel) -> RBD:
    n = robot.n
    parent = robot.parent
    subtrees = [list(robot.subtree(j)) for j in range(n)]
    consts = {}

    def C(like):
        """Per-(dtype, device) constants, built once (a host-to-device copy
        inside a solve would wait for the stream)."""
        key = (like.dtype, like.device)
        if key not in consts:
            t = lambda a: torch.as_tensor(np.asarray(a), dtype=like.dtype,
                                          device=like.device)
            A = torch.stack([spatial._skew(t(robot.axis[j])) for j in range(n)])
            consts[key] = dict(S=t(robot.S), I=t(robot.I_spatial),
                               Xf=t(robot.X_fixed), A=A, A2=A @ A,
                               I3=t(np.eye(3)), damping=t(robot.damping),
                               gravity={})
        return consts[key]

    def G(gravity, like):
        """The gravity vector; one per float value and (dtype, device)."""
        if torch.is_tensor(gravity):
            return _gravity_vec(gravity, like)
        cache = C(like)["gravity"]
        if gravity not in cache:
            cache[gravity] = _gravity_vec(gravity, like)
        return cache[gravity]

    def _X_all(q):
        """The n joint transforms (..., 6, 6) as a list."""
        K = C(q)
        return [spatial._free_times(robot.joint_type[j], K["I3"], K["A"][j],
                                    K["A2"][j], K["Xf"][j], q[..., j])
                for j in range(n)]

    # ------------------------------------------------------------------ RNEA
    def _fpass(X, qd, qdd, gravity):
        """(ref: RBDReference.py:399-484)"""
        K = C(qd)
        gvec = G(gravity, qd)
        v, a, f = [], [], []
        for i in range(n):
            Si, Ii = K["S"][i], K["I"][i]
            qdi = qd[..., i, None]
            if parent[i] == -1:
                vi = Si * qdi
                ai = X[i] @ gvec
            else:
                vi = mv(X[i], v[parent[i]]) + Si * qdi
                ai = mv(X[i], a[parent[i]])
            ai = ai + spatial.mxS(Si, vi, qd[..., i])
            if qdd is not None:
                ai = ai + Si * qdd[..., i, None]
            fi = ai @ Ii.T + spatial.vxIv(vi, Ii)
            v.append(vi)
            a.append(ai)
            f.append(fi)
        return v, a, f

    def _bpass(X, qd, f, use_damping):
        """(ref: RBDReference.py:486-532)"""
        K = C(qd)
        f = list(f)
        c = [None] * n
        for i in range(n - 1, -1, -1):
            c[i] = f[i] @ K["S"][i]
            if parent[i] != -1:
                f[parent[i]] = f[parent[i]] + mv(X[i].transpose(-1, -2), f[i])
        c = torch.stack(c, dim=-1)
        if use_damping:
            c = c + K["damping"] * qd
        return c, f

    def _rnea(X, qd, qdd, gravity, use_damping=False):
        v, a, f = _fpass(X, qd, qdd, gravity)
        c, f = _bpass(X, qd, f, use_damping)
        return c, v, a, f

    def rnea(q, qd, qdd=None, gravity=-9.81, use_damping=False):
        """Inverse dynamics (ref: RBDReference.py:534-559).  Returns
        (c, v, a, f) with v / a / f stacked as (..., 6, n)."""
        c, v, a, f = _rnea(_X_all(q), qd, qdd, gravity, use_damping)
        st = lambda vs: torch.stack(vs, dim=-1)
        return c, st(v), st(a), st(f)

    # --------------------------------------------------------- RNEA gradient
    def _rnea_grad(X, qd, qdd, gravity, use_damping):
        """Analytical d tau / d [q, qd], (..., n, 2n) (ref: RBDReference.py:
        561-802, four passes), the per-column cross-product loops as matrix
        products."""
        K = C(qd)
        gvec = G(gravity, qd)
        v, a, f = _fpass(X, qd, qdd, gravity)
        _, f_acc = _bpass(X, qd, f, False)
        zeros = qd.new_zeros(qd.shape[:-1] + (6, n))
        dv_dq, da_dq, df_dq = [], [], []
        dv_dqd, da_dqd, df_dqd = [], [], []
        for i in range(n):
            Si, Ii = K["S"][i], K["I"][i]
            crmS = crm(Si)
            qdi = qd[..., i, None, None]
            p = parent[i]
            # d/dq forward pass (ref: RBDReference.py:561-632)
            if p == -1:
                dv = zeros
                da = _add_col(zeros, i, spatial.mxS(Si, X[i] @ gvec))
            else:
                dv = _add_col(X[i] @ dv_dq[p], i, spatial.mxS(Si, mv(X[i], v[p])))
                da = _add_col(X[i] @ da_dq[p], i, spatial.mxS(Si, mv(X[i], a[p])))
            # for c: da[:, c] += mxS(S, dv[:, c], qd_i) == -qd_i crm(S) dv
            da = da - qdi * (crmS @ dv)
            Iv = v[i] @ Ii.T
            crf_v = crf(v[i])
            df = Ii @ da + icrf(Iv) @ dv + crf_v @ (Ii @ dv)
            dv_dq.append(dv)
            da_dq.append(da)
            df_dq.append(df)
            # d/dqd forward pass (ref: RBDReference.py:634-695)
            if p == -1:
                dvd, dad = zeros, zeros
            else:
                dvd, dad = X[i] @ dv_dqd[p], X[i] @ da_dqd[p]
            dvd = _add_col(dvd, i, Si)
            dad = dad - qdi * (crmS @ dvd)
            dad = _add_col(dad, i, spatial.mxS(Si, v[i]))
            dfd = Ii @ dad + icrf(Iv) @ dvd + crf_v @ (Ii @ dvd)
            dv_dqd.append(dvd)
            da_dqd.append(dad)
            df_dqd.append(dfd)
        # backward passes (ref: RBDReference.py:697-772)
        rows_q, rows_qd = [None] * n, [None] * n
        for i in range(n - 1, -1, -1):
            Si = K["S"][i]
            rows_q[i] = Si @ df_dq[i]
            rows_qd[i] = Si @ df_dqd[i]
            p = parent[i]
            if p != -1:
                Xt = X[i].transpose(-1, -2)
                upd = _add_col(Xt @ df_dq[i], i,
                               mv(Xt, spatial.fxS(Si, f_acc[i])))
                df_dq[p] = df_dq[p] + upd
                df_dqd[p] = df_dqd[p] + Xt @ df_dqd[i]
        dc_dq = torch.stack(rows_q, dim=-2)
        dc_dqd = torch.stack(rows_qd, dim=-2)
        if use_damping:
            dc_dqd = dc_dqd + torch.diag(K["damping"])
        return torch.cat([dc_dq, dc_dqd], dim=-1)

    def rnea_grad(q, qd, qdd=None, gravity=-9.81, use_damping=False):
        """Analytical d tau / d [q, qd], shape (..., n, 2n)."""
        return _rnea_grad(_X_all(q), qd, qdd, gravity, use_damping)

    # --------------------------------------------------------- analytic Minv
    def _minv(X, q, output_dense=True):
        """Analytic inverse of the joint-space inertia matrix (Carpentier)
        (ref: RBDReference.py:805-930)."""
        K = C(q)
        batch = q.shape[:-1]
        F = [q.new_zeros(batch + (6, n)) for _ in range(n)]
        IA = [K["I"][i].expand(batch + (6, 6)) for i in range(n)]
        rows, U, Dinv = [None] * n, [None] * n, [None] * n
        for i in range(n - 1, -1, -1):
            Si = K["S"][i]
            U[i] = IA[i] @ Si
            Dinv[i] = 1.0 / (U[i] @ Si)
            # F[i] is zero outside subtree(i): the full-width row holds the
            # JAX row's values there and zeros elsewhere
            row = -Dinv[i][..., None] * (Si @ F[i])
            rows[i] = _add_col(row, i, Dinv[i])
            p = parent[i]
            if p != -1:
                F[i] = F[i] + _outer(U[i], rows[i])
                Xt = X[i].transpose(-1, -2)
                F[p] = F[p] + Xt @ F[i]
                Ia = IA[i] - _outer(U[i], Dinv[i][..., None] * U[i])
                IA[p] = IA[p] + Xt @ (Ia @ X[i])
        for i in range(n):
            Si = K["S"][i]
            p = parent[i]
            if p != -1:
                UX = (U[i][..., None, :] @ X[i])                  # (..., 1, 6)
                tail = -Dinv[i][..., None] * (UX @ F[p][..., i:])[..., 0, :]
                rows[i] = torch.cat([rows[i][..., :i], rows[i][..., i:] + tail],
                                    dim=-1)
            Fi = _outer(Si, rows[i][..., i:])
            if p != -1:
                Fi = Fi + X[i] @ F[p][..., i:]
            F[i] = torch.cat([F[i][..., :i], Fi], dim=-1)
        Minv = torch.stack(rows, dim=-2)
        if output_dense:
            # mirror the upper triangle into the lower
            # (ref: RBDReference.py:921-928)
            upper = torch.triu(Minv)
            Minv = upper + torch.triu(upper, 1).transpose(-1, -2)
        return Minv

    def minv(q, output_dense=True):
        """Analytic Minv (..., n, n)."""
        return _minv(_X_all(q), q, output_dense)

    # ------------------------------------------------------------------ CRBA
    def crba(q):
        """Composite-rigid-body mass matrix H
        (ref: RBDReference_generalized.py:1000-1032)."""
        K = C(q)
        X = _X_all(q)
        IC = [K["I"][i] for i in range(n)]
        for i in range(n - 1, -1, -1):
            p = parent[i]
            if p != -1:
                IC[p] = IC[p] + (X[i].transpose(-1, -2) @ IC[i]) @ X[i]
        H = {}
        for i in range(n):
            fh = IC[i] @ K["S"][i]
            H[i, i] = fh @ K["S"][i]
            j = i
            while parent[j] > -1:
                fh = mv(X[j].transpose(-1, -2), fh)
                j = parent[j]
                H[i, j] = H[j, i] = fh @ K["S"][j]
        zero = torch.zeros_like(q[..., 0])
        return _stack_entries({k: v.expand(zero.shape) for k, v in H.items()},
                              n, zero)

    # ------------------------------------------------------------------- ABA
    def aba(q, qd, tau, gravity=-9.81):
        """Articulated-body forward dynamics
        (ref: RBDReference_generalized.py:913-998)."""
        K = C(q)
        X = _X_all(q)
        gvec = G(gravity, q)
        batch = q.shape[:-1]
        v, cvel = [], []
        IA = [K["I"][i].expand(batch + (6, 6)) for i in range(n)]
        pA = [None] * n
        for i in range(n):
            Si = K["S"][i]
            p = parent[i]
            if p == -1:
                vi = Si * qd[..., i, None]
                ci = torch.zeros_like(vi)
            else:
                vi = mv(X[i], v[p]) + Si * qd[..., i, None]
                ci = spatial.mxS(Si, vi, qd[..., i])
            v.append(vi)
            cvel.append(ci)
            pA[i] = mv(crf(vi), mv(IA[i], vi))
        U, d, u = [None] * n, [None] * n, [None] * n
        for i in range(n - 1, -1, -1):
            Si = K["S"][i]
            p = parent[i]
            U[i] = IA[i] @ Si
            d[i] = U[i] @ Si
            u[i] = tau[..., i] - pA[i] @ Si
            if p != -1:
                Ia = IA[i] - _outer(U[i], U[i]) / d[i][..., None, None]
                pa = (pA[i] + mv(Ia, cvel[i])
                      + U[i] * (u[i] / d[i])[..., None])
                Xt = X[i].transpose(-1, -2)
                IA[p] = IA[p] + (Xt @ Ia) @ X[i]
                pA[p] = pA[p] + mv(Xt, pa)
        a, qdd = [None] * n, [None] * n
        for i in range(n):
            p = parent[i]
            if p == -1:
                ai = X[i] @ gvec + cvel[i]
            else:
                ai = mv(X[i], a[p]) + cvel[i]
            qdd[i] = (u[i] - (U[i] * ai).sum(-1)) / d[i]
            a[i] = ai + qdd[i][..., None] * K["S"][i]
        return torch.stack(qdd, dim=-1)

    # ----------------------------------------------------------------- IDSVA
    def idsva(q, qd, qdd=None, gravity=-9.81):
        """Spatial-vector-algebra ID derivatives (Singh / Russel / Wensing)
        (ref: RBDReference_generalized.py:717-826); (dtau_dq, dtau_dqd)."""
        K = C(q)
        X = _X_all(q)
        gvec = G(gravity, q)
        v, a, f = [None] * n, [None] * n, [None] * n
        Xup0, Sw, Sd, Sdd, Sj, IC, BC = ([None] * n for _ in range(7))
        for i in range(n):
            p = parent[i]
            if p == -1:
                Xup0[i] = X[i]
                vi = q.new_zeros(q.shape[:-1] + (6,))
                ai = X[i] @ gvec
            else:
                Xup0[i] = X[i] @ Xup0[p]
                vi, ai = v[p], a[p]
            Si = mv(spatial.spatial_inv(Xup0[i]), K["S"][i])
            Sw[i] = Si
            crm_v = crm(vi)
            Sd[i] = mv(crm_v, Si)
            Sdd[i] = mv(crm(ai), Si) + mv(crm_v, Sd[i])
            Sj[i] = 2.0 * Sd[i] + mv(crm(Si * qd[..., i, None]), Si)
            vi = vi + Si * qd[..., i, None]
            ai = ai + mv(crm_v, Si) * qd[..., i, None]
            if qdd is not None:
                ai = ai + Si * qdd[..., i, None]
            v[i], a[i] = vi, ai
            Ii = Xup0[i].transpose(-1, -2) @ (K["I"][i] @ Xup0[i])
            IC[i] = Ii
            crf_v = crf(vi)
            f[i] = mv(Ii, ai) + mv(crf_v, mv(Ii, vi))
            BC[i] = crf_v @ Ii + icrf(mv(Ii, vi)) - Ii @ crm(vi)
        dq, dqd = {}, {}
        t1, t2, t3, t4 = ([None] * n for _ in range(4))
        for i in range(n - 1, -1, -1):
            t1[i] = mv(IC[i], Sw[i])
            t2[i] = mv(BC[i], Sw[i]) + mv(IC[i], Sj[i])
            t3[i] = (mv(BC[i], Sd[i]) + mv(IC[i], Sdd[i])
                     + mv(icrf(f[i]), Sw[i]))
            t4[i] = mv(BC[i].transpose(-1, -2), Sw[i])
            # row i over the strict subtree, column i over the subtree (the
            # descendants' t values are those of their own iterations)
            for k in subtrees[i][1:]:
                dq[i, k] = (Sw[i] * t3[k]).sum(-1)
                dqd[i, k] = (Sw[i] * t2[k]).sum(-1)
            for k in subtrees[i]:
                dq[k, i] = (Sdd[i] * t1[k]).sum(-1) + (Sd[i] * t4[k]).sum(-1)
                dqd[k, i] = (Sj[i] * t1[k]).sum(-1) + (Sw[i] * t4[k]).sum(-1)
            p = parent[i]
            if p >= 0:
                IC[p] = IC[p] + IC[i]
                BC[p] = BC[p] + BC[i]
                f[p] = f[p] + f[i]
        zero = torch.zeros_like(q[..., 0])
        return _stack_entries(dq, n, zero), _stack_entries(dqd, n, zero)

    # ------------------------------------------------- forward dynamics (FD)
    def fd(q, qd, u, gravity=-9.81):
        """qdd = Minv @ (u - c) (ref: TrajoptPlant.py:283-299)."""
        X = _X_all(q)
        c, _, _, _ = _rnea(X, qd, None, gravity)
        return mv(_minv(X, q), u - c)

    def fd_grad(q, qd, u, gravity=-9.81):
        """dqdd/d[q, qd, u] = [-Minv dc_dq, -Minv dc_dqd, Minv], shape
        (..., n, 3n) (ref: TrajoptPlant.py:301-323)."""
        X = _X_all(q)
        c, _, _, _ = _rnea(X, qd, None, gravity)
        Mi = _minv(X, q)
        qdd = mv(Mi, u - c)
        dc_du = _rnea_grad(X, qd, qdd, gravity, False)
        return torch.cat([-(Mi @ dc_du), Mi], dim=-1)

    return RBD(robot=robot, rnea=rnea, rnea_grad=rnea_grad, minv=minv,
               crba=crba, aba=aba, idsva=idsva, fd=fd, fd_grad=fd_grad)
