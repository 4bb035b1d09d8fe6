"""ctypes binding for the generated native dynamics library.

Port of trajoptmpcreference_tpu/native/lib.py.

``NativeDynamics(robot)`` generates, compiles (cached), and loads the
robot-specialized C++ library (codegen.py), exposing numpy-in/numpy-out
methods mirroring the RBD bundle (ops/rbd.py), one state a call.  Used as
the host-side
oracle in tests (the reference's printGRiD / testGRiDRefactorings pattern,
ref: GRiD/test/testGRiDRefactorings.py:20-101) and as a fast CPU runtime
for host-side rollouts.
"""

from __future__ import annotations

import ctypes

import numpy as np

from trajoptmpcreference_tpu_torch.models.robot import RobotModel
from trajoptmpcreference_tpu_torch.native.codegen import build

_D = ctypes.POINTER(ctypes.c_double)
_F, _I = ctypes.c_double, ctypes.c_int
# (argtypes, restype) of every entry codegen.generate_cpp exports
_SIGNATURES = {
    "tmr_n": ([], _I),
    "tmr_rnea": ([_D, _D, _D, _F, _D], None),
    "tmr_rnea_nogrv": ([_D, _D, _F, _D], None),
    "tmr_crba": ([_D, _D], None),
    "tmr_minv": ([_D, _D], None),
    "tmr_fd": ([_D, _D, _D, _F, _D], None),
    "tmr_rnea_grad": ([_D, _D, _D, _F, _D], None),
    "tmr_fd_grad": ([_D, _D, _D, _F, _D], None),
    "tmr_aba": ([_D, _D, _D, _F, _D], None),
    "tmr_idsva": ([_D, _D, _D, _F, _D, _D], None),
    "tmr_idsva_noqdd": ([_D, _D, _F, _D, _D], None),
    "tmr_ee_pos": ([_D, _D], None),
    "tmr_ee_jacobian": ([_D, _I, _D], None),
}


def _ptr(a):
    return a.ctypes.data_as(_D)


class NativeDynamics:
    def __init__(self, robot: RobotModel, cache_dir: str | None = None):
        self.robot = robot
        self.n = robot.n
        self._lib = ctypes.CDLL(str(build(robot, cache_dir)))
        for name, (args, res) in _SIGNATURES.items():
            fn = getattr(self._lib, name)
            fn.argtypes, fn.restype = args, res
        if self._lib.tmr_n() != self.n:
            raise RuntimeError(f"library built for n = {self._lib.tmr_n()}, "
                               f"robot has n = {self.n}")

    def _vec(self, x):
        a = np.ascontiguousarray(np.asarray(x, dtype=np.float64))
        if a.size != self.n:
            raise ValueError(f"expected {self.n} values, got {a.size}")
        return a

    def rnea(self, q, qd, qdd=None, gravity=-9.81):
        q, qd = self._vec(q), self._vec(qd)
        c = np.zeros(self.n)
        if qdd is None:
            self._lib.tmr_rnea_nogrv(_ptr(q), _ptr(qd),
                                     ctypes.c_double(gravity), _ptr(c))
        else:
            qdd = self._vec(qdd)
            self._lib.tmr_rnea(_ptr(q), _ptr(qd), _ptr(qdd),
                               ctypes.c_double(gravity), _ptr(c))
        return c

    def crba(self, q):
        q = self._vec(q)
        H = np.zeros((self.n, self.n))
        self._lib.tmr_crba(_ptr(q), _ptr(H))
        return H

    def minv(self, q):
        q = self._vec(q)
        Mi = np.zeros((self.n, self.n))
        self._lib.tmr_minv(_ptr(q), _ptr(Mi))
        return Mi

    def fd(self, q, qd, u, gravity=-9.81):
        q, qd, u = self._vec(q), self._vec(qd), self._vec(u)
        qdd = np.zeros(self.n)
        self._lib.tmr_fd(_ptr(q), _ptr(qd), _ptr(u),
                         ctypes.c_double(gravity), _ptr(qdd))
        return qdd

    def rnea_grad(self, q, qd, qdd=None, gravity=-9.81):
        q, qd = self._vec(q), self._vec(qd)
        out = np.zeros((self.n, 2 * self.n))
        if qdd is None:
            self._lib.tmr_rnea_grad(_ptr(q), _ptr(qd), None,
                                    ctypes.c_double(gravity), _ptr(out))
        else:
            qdd = self._vec(qdd)
            self._lib.tmr_rnea_grad(_ptr(q), _ptr(qd), _ptr(qdd),
                                    ctypes.c_double(gravity), _ptr(out))
        return out

    def fd_grad(self, q, qd, u, gravity=-9.81):
        q, qd, u = self._vec(q), self._vec(qd), self._vec(u)
        out = np.zeros((self.n, 3 * self.n))
        self._lib.tmr_fd_grad(_ptr(q), _ptr(qd), _ptr(u),
                              ctypes.c_double(gravity), _ptr(out))
        return out

    def aba(self, q, qd, tau, gravity=-9.81):
        q, qd, tau = self._vec(q), self._vec(qd), self._vec(tau)
        qdd = np.zeros(self.n)
        self._lib.tmr_aba(_ptr(q), _ptr(qd), _ptr(tau),
                          ctypes.c_double(gravity), _ptr(qdd))
        return qdd

    def idsva(self, q, qd, qdd=None, gravity=-9.81):
        q, qd = self._vec(q), self._vec(qd)
        dq = np.zeros((self.n, self.n))
        dqd = np.zeros((self.n, self.n))
        if qdd is None:
            self._lib.tmr_idsva_noqdd(_ptr(q), _ptr(qd),
                                      ctypes.c_double(gravity),
                                      _ptr(dq), _ptr(dqd))
        else:
            qdd = self._vec(qdd)
            self._lib.tmr_idsva(_ptr(q), _ptr(qd), _ptr(qdd),
                                ctypes.c_double(gravity), _ptr(dq), _ptr(dqd))
        return dq, dqd

    def ee_pos(self, q):
        q = self._vec(q)
        out = np.zeros(3)
        self._lib.tmr_ee_pos(_ptr(q), _ptr(out))
        return out

    def ee_jacobian(self, q, kdim=None):
        kdim = min(3, self.n) if kdim is None else kdim
        q = self._vec(q)
        J = np.zeros((kdim, self.n))
        self._lib.tmr_ee_jacobian(_ptr(q), ctypes.c_int(kdim), _ptr(J))
        return J
