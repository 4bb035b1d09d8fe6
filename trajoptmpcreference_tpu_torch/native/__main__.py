"""CLI for the native codegen layer, the analogue of the reference's GRiD
scripts (ref: GRiD/generateGRiD.py:80-94, GRiD/printGRiD.py:27-47,
GRiD/printReferenceValues.py:17-80); port of
trajoptmpcreference_tpu/native/__main__.py:

  python -m trajoptmpcreference_tpu_torch.native arm6           # 6-link arm
  python -m trajoptmpcreference_tpu_torch.native path/to.urdf   # any URDF
  python -m trajoptmpcreference_tpu_torch.native arm3 --emit out.cpp

Generates the robot-specialized C++ (codegen.generate_cpp), compiles it
with g++ (codegen.build, into build/native/), runs every exported
algorithm on fixed-seed random inputs (seed 1337, the reference's CUDA
smoke-test seed, ref: printGRiD.cu:10), prints the values, and
cross-checks each against the port's PyTorch implementations in f64 on
the CPU (ops/rbd.py, ops/kinematics.Kinematics, and the URDFPlant's lanes
dynamics) the way printReferenceValues.py pairs with printGRiD.cu across
the language boundary (tolerance 1e-10, ref: GRiD/util/util.py:59-69;
1e-7 where a linear solve sits between the two, as in the JAX package's
CLI).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def _robot(spec: str):
    from trajoptmpcreference_tpu_torch.models.urdf import parse_urdf, serial_arm
    if spec.startswith("arm") and spec[3:].isdigit():
        return serial_arm(int(spec[3:]))
    return parse_urdf(spec)


def _p(name, arr):
    with np.printoptions(precision=6, suppress=True, linewidth=100):
        print(f"{name} =\n{np.asarray(arr)}")


def references(robot, q, qd, u, qdd):
    """The port's PyTorch values of every native output, f64 on the CPU,
    as numpy: ops/rbd.py, ops/kinematics.Kinematics, and the lanes
    dynamics of URDFPlant (its xdot's and dxdot's acceleration rows)."""
    import torch

    from trajoptmpcreference_tpu_torch.models.plants import URDFPlant
    from trajoptmpcreference_tpu_torch.ops.kinematics import Kinematics
    from trajoptmpcreference_tpu_torch.ops.rbd import make_rbd
    n = robot.n
    rbd, kin = make_rbd(robot), Kinematics(robot)
    plant = URDFPlant(robot=robot)
    t = lambda a: torch.tensor(a, dtype=torch.float64)
    qt, qdt, ut, qddt = t(q), t(qd), t(u), t(qdd)
    x = torch.cat([qt, qdt])
    dq, dqd = rbd.idsva(qt, qdt, qddt)
    refs = {
        "ee_pos": kin.ee_pos_xyz(qt),
        "ee_jacobian": kin.jacobian(qt),
        "rnea (ID)": rbd.rnea(qt, qdt, qddt)[0],
        "crba (H)": rbd.crba(qt),
        "minv": rbd.minv(qt),
        "fd (qdd)": rbd.fd(qt, qdt, ut),
        "aba (qdd)": rbd.aba(qt, qdt, ut),
        "rnea_grad (dID)": rbd.rnea_grad(qt, qdt, qddt),
        "idsva dtau_dq": dq,
        "idsva dtau_dqd": dqd,
        "fd_grad (dFD)": rbd.fd_grad(qt, qdt, ut),
        "plant xdot (lanes fd)": plant.xdot(x, ut)[n:],
        "plant dxdot (lanes fd_grad)": plant.dxdot(x, ut)[n:],
    }
    return {k: v.numpy() for k, v in refs.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m trajoptmpcreference_tpu_torch.native",
        description=__doc__.splitlines()[0])
    ap.add_argument("robot", help="'armN' for an N-link serial arm, or a "
                                  "URDF path")
    ap.add_argument("--emit", metavar="FILE",
                    help="write the generated C++ to FILE and exit "
                         "(the generateGRiD.py analogue)")
    ap.add_argument("--seed", type=int, default=1337,
                    help="input seed (default: the reference's 1337)")
    ap.add_argument("--tol", type=float, default=1e-10,
                    help="cross-check tolerance (default 1e-10, the "
                         "reference's printErr bar)")
    args = ap.parse_args(argv)

    robot = _robot(args.robot)
    n = robot.n
    print(f"robot: {robot.name} (n = {n})")

    from trajoptmpcreference_tpu_torch.native.codegen import build, generate_cpp
    if args.emit:
        with open(args.emit, "w") as f:
            f.write(generate_cpp(robot))
        print(f"wrote {args.emit}")
        return 0

    print(f"compiled: {build(robot)}")

    from trajoptmpcreference_tpu_torch.native.lib import NativeDynamics
    native = NativeDynamics(robot)

    rng = np.random.default_rng(args.seed)
    q = rng.standard_normal(n)
    qd = rng.standard_normal(n)
    u = rng.standard_normal(n)
    qdd = rng.standard_normal(n)
    _p("q", q)
    _p("qd", qd)
    _p("u", u)
    _p("qdd", qdd)

    # native outputs (the printGRiD.cu print set: eePos/ID/Minv/FD/dID/dFD,
    # plus the generalized layer's ABA/CRBA/IDSVA)
    fd, fd_grad = native.fd(q, qd, u), native.fd_grad(q, qd, u)
    outs = {
        "ee_pos": native.ee_pos(q),
        "ee_jacobian": native.ee_jacobian(q),
        "rnea (ID)": native.rnea(q, qd, qdd),
        "crba (H)": native.crba(q),
        "minv": native.minv(q),
        "fd (qdd)": fd,
        "aba (qdd)": native.aba(q, qd, u),
        "rnea_grad (dID)": native.rnea_grad(q, qd, qdd),
        "idsva dtau_dq": native.idsva(q, qd, qdd)[0],
        "idsva dtau_dqd": native.idsva(q, qd, qdd)[1],
        "fd_grad (dFD)": fd_grad,
        "plant xdot (lanes fd)": fd,
        "plant dxdot (lanes fd_grad)": fd_grad,
    }
    for name, val in outs.items():
        if not name.startswith("plant"):
            _p(name, val)

    refs = references(robot, q, qd, u, qdd)
    loose = {"minv", "fd (qdd)", "fd_grad (dFD)", "ee_jacobian",
             "plant xdot (lanes fd)", "plant dxdot (lanes fd_grad)"}
    fails = 0
    for name, val in outs.items():
        ref = refs[name]
        tol = max(args.tol, 1e-7) if name in loose else args.tol
        err = float(np.max(np.abs(np.asarray(val) - ref)))
        ok = err <= tol
        fails += (not ok)
        print(f"check {name}: max |native - torch| = {err:.2e} "
              f"{'OK' if ok else f'FAIL (tol {tol:g})'}")
    print("ALL CHECKS PASSED" if fails == 0 else f"{fails} CHECKS FAILED")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
