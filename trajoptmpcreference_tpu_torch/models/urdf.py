"""URDF parsing to a numeric RobotModel.

Re-implements the reference's parsing semantics (ref: GRiD/URDFParser/
URDFParser.py:227-445) with plain ElementTree + numpy (no sympy, no
lambdification): links with inertials, joints with origins/axes/damping,
fixed-joint elimination that folds transforms and inertias into the parent
(ref: URDFParser.py:330-351), and DFS renumbering rooted at the unique base
link, with the base link given id -1 (ref: URDFParser.py:420-435).
"""

from __future__ import annotations

import dataclasses
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional

import numpy as np

from trajoptmpcreference_tpu_torch.models.robot import (
    PRISMATIC,
    REVOLUTE,
    RobotModel,
    fixed_spatial_transform,
    rpy_to_E,
    spatial_inertia,
)


@dataclasses.dataclass
class _Link:
    name: str
    origin_xyz: np.ndarray
    origin_rpy: np.ndarray
    mass: float
    inertia3: np.ndarray  # 3x3
    I6: np.ndarray = dataclasses.field(init=False)

    def __post_init__(self):
        self.I6 = spatial_inertia(self.mass, self.origin_xyz, self.inertia3)


@dataclasses.dataclass
class _Joint:
    name: str
    jtype: str
    parent: str
    child: str
    xyz: np.ndarray
    rpy: np.ndarray
    axis: Optional[np.ndarray]
    damping: float
    # composed fixed transform pieces (updated by fixed-joint elimination)
    E_fixed: np.ndarray = dataclasses.field(init=False)
    t_fixed: np.ndarray = dataclasses.field(init=False)
    X_fixed: np.ndarray = dataclasses.field(init=False)

    def __post_init__(self):
        self.E_fixed = rpy_to_E(self.rpy)
        self.t_fixed = np.asarray(self.xyz, dtype=float)
        self.X_fixed = fixed_spatial_transform(self.rpy, self.xyz)


def _floats(s: str) -> np.ndarray:
    return np.array([float(v) for v in s.split()], dtype=float)


def _parse_links(root) -> Dict[str, _Link]:
    links: Dict[str, _Link] = {}
    for raw in root.findall(".//link"):
        name = raw.get("name")
        origin = raw.find("origin")
        if origin is not None:
            xyz = _floats(origin.get("xyz", "0 0 0"))
            rpy = _floats(origin.get("rpy", "0 0 0"))
        else:
            xyz = np.zeros(3)
            rpy = np.zeros(3)
        inertial = raw.find("inertial")
        if inertial is not None:
            mass = float(inertial.find("mass").get("value", "0"))
            inr = inertial.find("inertia")
            ixx = float(inr.get("ixx", "0"))
            ixy = float(inr.get("ixy", "0"))
            ixz = float(inr.get("ixz", "0"))
            iyy = float(inr.get("iyy", "0"))
            iyz = float(inr.get("iyz", "0"))
            izz = float(inr.get("izz", "0"))
            I3 = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
        else:
            mass = 0.0
            I3 = np.zeros((3, 3))
        links[name] = _Link(name, xyz, rpy, mass, I3)
    return links


def _parse_joints(root) -> List[_Joint]:
    joints: List[_Joint] = []
    for raw in root.findall(".//joint"):
        origin = raw.find("origin")
        xyz = _floats(origin.get("xyz", "0 0 0")) if origin is not None else np.zeros(3)
        rpy = _floats(origin.get("rpy", "0 0 0")) if origin is not None else np.zeros(3)
        axis_el = raw.find("axis")
        axis = _floats(axis_el.get("xyz")) if axis_el is not None else None
        dyn = raw.find("dynamics")
        damping = float(dyn.get("damping", "0")) if dyn is not None else 0.0
        joints.append(
            _Joint(
                name=raw.get("name"),
                jtype=raw.get("type"),
                parent=raw.find("parent").get("link"),
                child=raw.find("child").get("link"),
                xyz=xyz,
                rpy=rpy,
                axis=axis,
                damping=damping,
            )
        )
    return joints


def _remove_fixed_joints(links: Dict[str, _Link], joints: List[_Joint]) -> List[_Joint]:
    """Fold each fixed joint's transform/inertia into its parent.

    Matches ref: URDFParser.py:330-351 — for grandchild joints, the fixed
    transform composes on the right (X_gc <- X_gc @ X_fixedjoint); the child
    inertia transforms into the parent frame as I_parent += X^T I_child X.
    For the homogeneous pieces the rotation composes as E_gc <- E_gc @ E_fj
    and the translation as t_gc <- E_fj^T t_gc + t_fj; prismatic/revolute
    axes stay expressed in the (unchanged) child joint frame.
    """
    out = list(joints)
    for fj in joints:
        if fj.jtype != "fixed":
            continue
        for gc in out:
            if gc is fj or gc.parent != fj.child:
                continue
            gc.parent = fj.parent
            gc.X_fixed = gc.X_fixed @ fj.X_fixed
            gc.t_fixed = fj.E_fixed.T @ gc.t_fixed + fj.t_fixed
            gc.E_fixed = gc.E_fixed @ fj.E_fixed
        child = links[fj.child]
        parent = links[fj.parent]
        parent.I6 = parent.I6 + fj.X_fixed.T @ child.I6 @ fj.X_fixed
        del links[fj.child]
        out.remove(fj)
    return out


def parse_urdf(path: str, alpha_tie_breaker: bool = False) -> RobotModel:
    """Parse a URDF file into a RobotModel.

    Joint/link ids follow the reference's DFS ordering from the root link
    (ref: URDFParser.py:370-387), with optional alphabetical tie-breaking
    among siblings.
    """
    tree = ET.parse(path)
    root = tree.getroot()
    name = root.get("name")

    links = _parse_links(root)
    joints = _parse_joints(root)
    joints = _remove_fixed_joints(links, joints)

    # find the root link: the one that is never a child
    children = {j.child for j in joints}
    roots = [ln for ln in links if ln not in children]
    if len(roots) != 1:
        raise ValueError(f"URDF must have exactly one root link, found {roots}")
    root_link = roots[0]

    # DFS numbering
    order: List[_Joint] = []
    parent_id: List[int] = []

    def dfs(link_name: str, pid: int):
        kids = [j for j in joints if j.parent == link_name]
        if alpha_tie_breaker:
            kids.sort(key=lambda j: j.name)
        for j in kids:
            jid = len(order)
            order.append(j)
            parent_id.append(pid)
            dfs(j.child, jid)

    dfs(root_link, -1)

    n = len(order)
    if n == 0:
        raise ValueError("URDF has no movable joints")

    joint_type = []
    axis = np.zeros((n, 3))
    X_fixed = np.zeros((n, 6, 6))
    E_fixed = np.zeros((n, 3, 3))
    t_fixed = np.zeros((n, 3))
    I6 = np.zeros((n, 6, 6))
    damping = np.zeros(n)

    for jid, j in enumerate(order):
        if j.jtype in ("revolute", "continuous"):
            joint_type.append(REVOLUTE)
        elif j.jtype == "prismatic":
            joint_type.append(PRISMATIC)
        else:
            raise ValueError(f"Unsupported joint type {j.jtype!r} after fixed-joint elimination")
        a = j.axis if j.axis is not None else np.array([0.0, 0.0, 1.0])
        norm = np.linalg.norm(a)
        if norm == 0:
            raise ValueError(f"Joint {j.name!r} has zero axis")
        axis[jid] = a / norm
        X_fixed[jid] = j.X_fixed
        E_fixed[jid] = j.E_fixed
        t_fixed[jid] = j.t_fixed
        I6[jid] = links[j.child].I6
        damping[jid] = j.damping

    return RobotModel(
        name=name,
        parent=tuple(parent_id),
        joint_type=tuple(joint_type),
        axis=axis,
        X_fixed=X_fixed,
        E_fixed=E_fixed,
        t_fixed=t_fixed,
        I_spatial=I6,
        damping=damping,
    )


def serial_arm(n_links: int, link_length: float = 1.0, link_mass: float = 0.1) -> RobotModel:
    """Build an n-link planar serial arm equivalent to the reference's
    models/arm{2..6}.urdf (z-axis revolute joints, links along +y,
    ref: models/arm2.urdf:5-33) without needing a URDF file on disk.
    """
    half = link_length / 2.0
    # rod inertia values matching the reference URDF files exactly
    # (ixx = m*(l^2/12 + (l/2)^2)? the files use 0.0083958333 for m=0.1, l=1)
    ixx = 0.008395833333333333 * (link_mass / 0.1) * (link_length ** 2)
    izz = 0.00012500000000000003 * (link_mass / 0.1)
    n = n_links
    parent = tuple(range(-1, n - 1))
    joint_type = tuple([REVOLUTE] * n)
    axis = np.tile(np.array([0.0, 0.0, 1.0]), (n, 1))
    X_fixed = np.zeros((n, 6, 6))
    E_fixed = np.zeros((n, 3, 3))
    t_fixed = np.zeros((n, 3))
    I6 = np.zeros((n, 6, 6))
    I3 = np.diag([ixx, ixx, izz])
    for j in range(n):
        xyz = np.zeros(3) if j == 0 else np.array([0.0, link_length, 0.0])
        X_fixed[j] = fixed_spatial_transform(np.zeros(3), xyz)
        E_fixed[j] = np.eye(3)
        t_fixed[j] = xyz
        # the reference builds spatial inertia from the link origin xyz as COM
        # and the URDF 3x3 inertia untransformed (ref: Link.py:48-66)
        I6[j] = spatial_inertia(link_mass, np.array([0.0, half, 0.0]), I3)
    return RobotModel(
        name=f"{n}_link",
        parent=parent,
        joint_type=joint_type,
        axis=axis,
        X_fixed=X_fixed,
        E_fixed=E_fixed,
        t_fixed=t_fixed,
        I_spatial=I6,
        damping=np.zeros(n),
    )
