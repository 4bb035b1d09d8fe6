"""The planar serial arm of the configurations, written from its physics.

A chain of ``links`` rigid links that turn about the world z axis: link i
starts at joint i, runs ``link_length`` along its own +y axis, has mass
``link_mass`` at its midpoint and rotational inertia diag(ixx_com,
ixx_com, izz_com) about its centre of mass.  Joint angles add up along the chain, so link i points
along (-sin phi_i, cos phi_i) with phi_i = q_0 + ... + q_i.  Gravity acts
along z, across every joint axis, and so does no work in the plane.

The forward dynamics are the articulated-body algorithm in spatial
vectors, written out for this chain; the kinematics are the chain's
closed form.  The step (semi-implicit Euler) and the task-space residual
of the cost are differentiated by forward-mode autodiff (``torch.func``),
not by hand.  Everything here is plain PyTorch and takes the batch as
leading dimensions.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd, vmap

# lanes per vmapped call: bounds the memory of the nested derivatives
CHUNK = 32768


def _skew(r):
    z = torch.zeros_like(r[0])
    return torch.stack([torch.stack([z, -r[2], r[1]]),
                        torch.stack([r[2], z, -r[0]]),
                        torch.stack([-r[1], r[0], z])])


def _crm(v):
    """Spatial cross product for motion vectors, v = [w; v_lin]."""
    w, vl = _skew(v[:3]), _skew(v[3:])
    z = torch.zeros_like(w)
    return torch.cat([torch.cat([w, z], 1), torch.cat([vl, w], 1)], 0)


def _crf(v):
    return -_crm(v).T


class PlanarArm:
    def __init__(self, robot: dict, dt: float, sim_qd_max: float):
        self.n = int(robot["links"])
        self.length = float(robot["link_length"])
        self.mass = float(robot["link_mass"])
        self.izz = float(robot["izz_com"])
        self.ixx = float(robot["ixx_com"])
        self.gravity = float(robot["gravity"])
        self.ee_offset = float(robot["ee_offset"])
        self.dt = float(dt)
        self.sim_qd_max = float(sim_qd_max)
        self.nx, self.nu = 2 * self.n, self.n

    # ------------------------------------------------------ one sample
    def _dirs(self, q):
        phi = torch.cumsum(q, 0)
        return torch.stack([-torch.sin(phi), torch.cos(phi)], dim=-1)  # (n, 2)

    def _joints(self, q):
        """Joint origins (n, 2): joint 0 at the base, joint i + 1 one link
        along link i."""
        d = self._dirs(q)
        ends = torch.cumsum(self.length * d, 0)
        return torch.cat([torch.zeros_like(ends[:1]), ends[:-1]], 0), d

    def ee(self, q):
        o, d = self._joints(q)
        return o[-1] + self.ee_offset * d[-1]

    def _consts(self, like):
        """Per-link spatial inertia about the joint (mass at the link's
        midpoint, izz_com about it), the fixed transform from the parent
        (one link along +y) and the joint's motion subspace (z)."""
        t = lambda a: torch.as_tensor(a, dtype=like.dtype, device=like.device)
        m, L = self.mass, self.length
        c = t([0.0, 0.5 * L, 0.0])
        cx = _skew(c)
        Ic = torch.diag(t([self.ixx, self.ixx, self.izz]))
        I = torch.cat([torch.cat([Ic + m * cx @ cx.T, m * cx], 1),
                       torch.cat([m * cx.T, m * torch.eye(3, dtype=like.dtype,
                                                          device=like.device)], 1)], 0)
        rx = _skew(t([0.0, L, 0.0]))
        eye3 = torch.eye(3, dtype=like.dtype, device=like.device)
        XT = torch.cat([torch.cat([eye3, torch.zeros_like(eye3)], 1),
                        torch.cat([-rx, eye3], 1)], 0)
        S = t([0.0, 0.0, 1.0, 0.0, 0.0, 0.0])
        # gravity -9.81 along z as the base's fictitious acceleration
        a0 = t([0.0, 0.0, 0.0, 0.0, 0.0, -self.gravity])
        return I, XT, S, a0

    def _fd(self, q, qd, u):
        """Forward dynamics by the articulated-body algorithm (Featherstone,
        Rigid Body Dynamics Algorithms, table 7.1) for the serial chain;
        every joint is revolute about its own z."""
        n = self.n
        I, XT, S, a0 = self._consts(q)
        z6 = torch.zeros(6, dtype=q.dtype, device=q.device)
        X, v, c, IA, pA = [], [], [], [], []
        for i in range(n):
            co, si = torch.cos(q[i]), torch.sin(q[i])
            one, zero = torch.ones_like(co), torch.zeros_like(co)
            E = torch.stack([torch.stack([co, si, zero]),
                             torch.stack([-si, co, zero]),
                             torch.stack([zero, zero, one])])
            ZE = torch.zeros_like(E)
            XJ = torch.cat([torch.cat([E, ZE], 1), torch.cat([ZE, E], 1)], 0)
            Xi = XJ @ XT if i > 0 else XJ
            vJ = S * qd[i]
            vi = (Xi @ v[-1] if i > 0 else z6) + vJ
            X.append(Xi)
            v.append(vi)
            c.append(_crm(vi) @ vJ)
            IA.append(I)
            pA.append(_crf(vi) @ (I @ vi))
        U, D, uu = [None] * n, [None] * n, [None] * n
        for i in reversed(range(n)):
            U[i] = IA[i] @ S
            D[i] = S @ U[i]
            uu[i] = u[i] - S @ pA[i]
            if i > 0:
                Ia = IA[i] - torch.outer(U[i], U[i]) / D[i]
                pa = pA[i] + Ia @ c[i] + U[i] * (uu[i] / D[i])
                IA[i - 1] = IA[i - 1] + X[i].T @ Ia @ X[i]
                pA[i - 1] = pA[i - 1] + X[i].T @ pa
        qdd, a = [], a0
        for i in range(n):
            ap = X[i] @ a + c[i]
            qi = (uu[i] - U[i] @ ap) / D[i]
            qdd.append(qi)
            a = ap + S * qi
        return torch.stack(qdd)

    def _step(self, x, u):
        n, dt = self.n, self.dt
        q, qd = x[:n], x[n:]
        v1 = qd + dt * self._fd(q, qd, u)
        return torch.cat([q + dt * v1, v1])

    def _task(self, x):
        """[ee x, ee y, 0; its velocity J(q) qd, 0]: the task-space
        residual's first three (position) and last three (velocity) rows."""
        n = self.n
        q, qd = x[:n], x[n:]
        p = self.ee(q)
        v = jacfwd(self.ee)(q) @ qd
        z = torch.zeros_like(p[:1])
        return torch.cat([p, z, v, z])

    # --------------------------------------------------------- batched
    @staticmethod
    def _map(fn, *args):
        """fn over the flattened leading dims of args (…, d_i), in chunks."""
        lead = args[0].shape[:-1]
        flat = [a.expand(lead + a.shape[-1:]).reshape(-1, a.shape[-1])
                for a in args]
        L = flat[0].shape[0]
        outs = [vmap(fn)(*(f[i:i + CHUNK] for f in flat))
                for i in range(0, L, CHUNK)]
        if isinstance(outs[0], tuple):
            return tuple(torch.cat(parts).reshape(lead + parts[0].shape[1:])
                         for parts in zip(*outs))
        out = torch.cat(outs)
        return out.reshape(lead + out.shape[1:])

    def step(self, x, u):
        """x_{k+1} (…, nx) of the solver's model."""
        return self._map(self._step, x, u)

    def step_jacobians(self, x, u):
        """(A (…, nx, nx), B (…, nx, nu)) of ``step``."""
        return self._map(jacfwd(self._step, argnums=(0, 1)), x, u)

    def task(self, x):
        return self._map(self._task, x)

    def task_jacobian(self, x):
        return self._map(jacfwd(self._task), x)

    def ee_xy(self, x):
        return self._map(lambda xx: self.ee(xx[:self.n]), x)

    def simulate(self, x, u):
        """The simulated arm: one step with its joint speeds clamped."""
        x1 = self.step(x, u)
        n = self.n
        return torch.cat([x1[..., :n],
                          x1[..., n:].clamp(-self.sim_qd_max, self.sim_qd_max)],
                         dim=-1)
