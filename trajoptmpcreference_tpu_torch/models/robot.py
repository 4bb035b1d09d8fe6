"""Static robot model: topology-as-data (numpy only).

A copy of trajoptmpcreference_tpu/models/robot.py: that package's
``__init__`` imports jax, so the port cannot import the module from there.
The robot is a frozen container of plain numpy arrays — fixed spatial
transforms, joint axes, spatial inertias, parent/ancestor/subtree tables —
which the dynamics code packs into one constant buffer per robot for the
CUDA kernels (ops/lanes.pack_robot), the way the GRiD code generator
specializes CUDA per URDF (ref: GRiD/GRiDCodeGenerator/
GRiDCodeGenerator.py:261-353).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

REVOLUTE = 0
PRISMATIC = 1


@dataclasses.dataclass(frozen=True)
class RobotModel:
    """Frozen numeric robot description (all arrays float64 numpy).

    Attributes
    ----------
    name:        robot name from the URDF.
    parent:      tuple of parent joint ids, -1 for children of the fixed base.
    joint_type:  tuple of REVOLUTE / PRISMATIC codes.
    axis:        (n,3) unit joint axis in the joint frame (generalizes the
                 reference's principal-axis-only support,
                 ref: GRiD/URDFParser/Joint.py:52-84).
    X_fixed:     (n,6,6) fixed spatial motion transform per joint,
                 X_fixed = rot(E_origin) @ xlt(skew(t_origin)).
    E_fixed:     (n,3,3) fixed Featherstone rotation E (parent->joint frame).
    t_fixed:     (n,3)   fixed translation (joint origin xyz in parent frame).
    I_spatial:   (n,6,6) spatial inertia per body in its own joint frame.
    damping:     (n,) viscous joint damping.
    """

    name: str
    parent: Tuple[int, ...]
    joint_type: Tuple[int, ...]
    axis: np.ndarray
    X_fixed: np.ndarray
    E_fixed: np.ndarray
    t_fixed: np.ndarray
    I_spatial: np.ndarray
    damping: np.ndarray

    # ---- static topology queries (all computed, not stored) ----

    @property
    def n(self) -> int:
        return len(self.parent)

    def get_num_pos(self) -> int:
        return self.n

    def get_num_vel(self) -> int:
        return self.n

    def get_num_cntrl(self) -> int:
        return self.n

    @property
    def S(self) -> np.ndarray:
        """(n,6) motion subspace vectors: [axis;0] revolute, [0;axis] prismatic."""
        S = np.zeros((self.n, 6))
        for j in range(self.n):
            if self.joint_type[j] == REVOLUTE:
                S[j, :3] = self.axis[j]
            else:
                S[j, 3:] = self.axis[j]
        return S

    def ancestors(self, j: int) -> Tuple[int, ...]:
        out = []
        p = self.parent[j]
        while p != -1:
            out.append(p)
            p = self.parent[p]
        return tuple(sorted(out))

    def subtree(self, j: int) -> Tuple[int, ...]:
        """Joint ids in the subtree rooted at j, inclusive, sorted."""
        out = [j]
        # children have larger ids under DFS numbering
        for k in range(j + 1, self.n):
            p = self.parent[k]
            while p != -1 and p != j:
                p = self.parent[p]
            if p == j:
                out.append(k)
        return tuple(sorted(out))

    @property
    def ancestor_mask(self) -> np.ndarray:
        """(n,n) bool, [i,j] True iff i is a strict ancestor of j."""
        m = np.zeros((self.n, self.n), dtype=bool)
        for j in range(self.n):
            for a in self.ancestors(j):
                m[a, j] = True
        return m

    @property
    def subtree_mask(self) -> np.ndarray:
        """(n,n) bool, [i,j] True iff j is in subtree(i) (inclusive)."""
        m = np.eye(self.n, dtype=bool)
        return m | self.ancestor_mask

    @property
    def leaves(self) -> Tuple[int, ...]:
        return tuple(j for j in range(self.n) if len(self.subtree(j)) == 1)

    @property
    def bfs_level(self) -> np.ndarray:
        """(n,) depth of each joint below the fixed base (base children = 0).

        The reference's secondary BFS numbering (ref: GRiD/URDFParser/
        URDFParser.py:389-418 bfs_order; level drives which joints a
        level-parallel kernel may process together).  Derived from
        ``parent`` — topology-as-data, nothing stored."""
        lvl = np.zeros(self.n, dtype=np.int64)
        for j in range(self.n):        # parents precede children (DFS ids)
            p = self.parent[j]
            lvl[j] = 0 if p < 0 else lvl[p] + 1
        return lvl

    @property
    def bfs_order(self) -> np.ndarray:
        """(n,) joint ids in BFS (level-major) order.  Within a level the
        DFS ids keep the reference's sibling declaration order, so this
        matches its bfs_id assignment (ref: URDFParser.py:389-418)."""
        return np.argsort(self.bfs_level, kind="stable")

    def joints_by_bfs_level(self) -> Tuple[Tuple[int, ...], ...]:
        """Joint ids grouped per BFS level — the unit of tree-parallelism
        (the reference's get_ids_by_bfs_level analogue)."""
        lvl = self.bfs_level
        return tuple(
            tuple(int(j) for j in np.flatnonzero(lvl == d))
            for d in range(int(lvl.max()) + 1))

    def is_serial_chain(self) -> bool:
        return all(j - self.parent[j] == 1 for j in range(self.n))

    def __hash__(self):
        return hash((self.name, self.parent, self.joint_type,
                     self.axis.tobytes(), self.X_fixed.tobytes(),
                     self.I_spatial.tobytes(), self.t_fixed.tobytes(),
                     self.damping.tobytes()))

    def __eq__(self, other):
        if not isinstance(other, RobotModel):
            return NotImplemented
        return (self.name == other.name and self.parent == other.parent
                and self.joint_type == other.joint_type
                and np.array_equal(self.axis, other.axis)
                and np.array_equal(self.X_fixed, other.X_fixed)
                and np.array_equal(self.I_spatial, other.I_spatial)
                and np.array_equal(self.t_fixed, other.t_fixed)
                and np.array_equal(self.damping, other.damping))


# ---- numeric constructors used by the URDF parser ------------------------

def skew(v: np.ndarray) -> np.ndarray:
    x, y, z = v
    return np.array([[0.0, -z, y], [z, 0.0, -x], [-y, x, 0.0]])


def rot_x(theta: float) -> np.ndarray:
    """Featherstone coordinate rotation about x (ref: SpatialAlgebra.py:48-52)."""
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[1, 0, 0], [0, c, s], [0, -s, c]], dtype=float)


def rot_y(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]], dtype=float)


def rot_z(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]], dtype=float)


def rpy_to_E(rpy) -> np.ndarray:
    """Fixed-origin Featherstone rotation E = rx(r) @ ry(p) @ rz(y)
    (ref: SpatialAlgebra.py:42-46)."""
    r, p, y = rpy
    return rot_x(r) @ rot_y(p) @ rot_z(y)


def spatial_rot(E: np.ndarray) -> np.ndarray:
    """6x6 motion transform for a pure rotation: blkdiag(E, E)."""
    X = np.zeros((6, 6))
    X[:3, :3] = E
    X[3:, 3:] = E
    return X


def spatial_xlt(t: np.ndarray) -> np.ndarray:
    """6x6 motion transform for a pure translation: [[I,0],[-skew(t),I]]
    (ref: SpatialAlgebra.py:20-23)."""
    X = np.eye(6)
    X[3:, :3] = -skew(t)
    return X


def fixed_spatial_transform(rpy, xyz) -> np.ndarray:
    """X_fixed = rot(E) @ xlt(skew(t)) (ref: SpatialAlgebra.py:93)."""
    return spatial_rot(rpy_to_E(rpy)) @ spatial_xlt(np.asarray(xyz, dtype=float))


def spatial_inertia(mass: float, com_xyz, I3: np.ndarray) -> np.ndarray:
    """Spatial inertia about the joint frame.

    I6 = [[I3 + m*cx*cx^T, m*cx], [m*cx^T, m*I]] with cx = skew(com)
    (ref: GRiD/URDFParser/Link.py:48-66; note the reference takes the COM from
    the *link* origin xyz and uses the URDF 3x3 inertia untransformed — we
    preserve that semantic for parity).
    """
    cx = skew(np.asarray(com_xyz, dtype=float))
    mc = mass * cx
    I6 = np.zeros((6, 6))
    I6[:3, :3] = np.asarray(I3, dtype=float) + mc @ cx.T
    I6[:3, 3:] = mc
    I6[3:, :3] = mc.T
    I6[3:, 3:] = mass * np.eye(3)
    I6[np.isclose(I6, 0.0, rtol=1e-10, atol=1e-10)] = 0.0
    return I6
