"""Robot-specialized C++ code generation (the GRiD-codegen analogue).

Port of trajoptmpcreference_tpu/native/codegen.py, over the port's own
RobotModel and its own copy of the algorithm header (dynamics.hpp).
``generate_cpp(robot)`` emits a .cpp baking the robot's constants (parents,
joint types/axes, fixed transforms, spatial inertias, EE offset) next to the
generic algorithm header, with an extern "C" API — the same specialization
strategy as the reference's GRiDCodeGenerator (robot constants + generic
algorithm code, ref: GRiDCodeGenerator.py:261-353, helpers/_topology_helpers
.py) targeting the host CPU instead of CUDA.

``build(robot)`` compiles it with g++ -O3 into a shared library under
``<repo>/build/native/`` (or a given cache directory), named by a hash of
the source and the header; ``native/lib.py`` loads it through ctypes.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import subprocess
import tempfile

import numpy as np

from trajoptmpcreference_tpu_torch.models.robot import RobotModel

_HEADER = pathlib.Path(__file__).resolve().parent / "dynamics.hpp"
BUILD_ROOT = _HEADER.parents[2] / "build" / "native"


def _carr(name, arr, ctype="double"):
    flat = np.asarray(arr).ravel()
    if ctype == "int":
        vals = ", ".join(str(int(v)) for v in flat)
    else:
        vals = ", ".join(repr(float(v)) for v in flat)
    return f"static const {ctype} {name}[] = {{{vals}}};"


def generate_cpp(robot: RobotModel, ee_offset=(0.0, 1.0, 0.0, 1.0)) -> str:
    n = robot.n
    # dynamics.hpp kernels use fixed stack buffers sized TMR_MAX_N; a larger
    # robot would silently overflow the stack
    if n > 32:
        raise ValueError(
            f"native dynamics kernels support n <= 32 joints (got n = {n}); "
            "raise TMR_MAX_N in dynamics.hpp to extend")
    parts = [
        f'#include "{_HEADER}"',
        "",
        "// ---- robot constants baked by codegen.py "
        f"(robot: {robot.name}, n = {n}) ----",
        _carr("k_parent", robot.parent, "int"),
        _carr("k_jtype", robot.joint_type, "int"),
        _carr("k_axis", robot.axis),
        _carr("k_X_fixed", robot.X_fixed),
        _carr("k_E_fixed", robot.E_fixed),
        _carr("k_t_fixed", robot.t_fixed),
        _carr("k_S", robot.S),
        _carr("k_I", robot.I_spatial),
        _carr("k_damping", robot.damping),
        _carr("k_ee_offset", np.asarray(ee_offset)),
        "",
        "static const tmr::RobotConst k_robot = {",
        f"  {n}, k_parent, k_jtype, k_axis, k_X_fixed, k_E_fixed,",
        "  k_t_fixed, k_S, k_I, k_damping, k_ee_offset};",
        "",
        'extern "C" {',
        f"int tmr_n() {{ return {n}; }}",
        "void tmr_rnea(const double* q, const double* qd, const double* qdd,",
        "              double gravity, double* c) {",
        "  tmr::rnea(k_robot, q, qd, qdd, gravity, c);",
        "}",
        "void tmr_rnea_nogrv(const double* q, const double* qd, double gravity,",
        "                    double* c) {",
        "  tmr::rnea(k_robot, q, qd, nullptr, gravity, c);",
        "}",
        "void tmr_crba(const double* q, double* H) { tmr::crba(k_robot, q, H); }",
        "void tmr_minv(const double* q, double* Mi) { tmr::minv(k_robot, q, Mi); }",
        "void tmr_fd(const double* q, const double* qd, const double* u,",
        "            double gravity, double* qdd) {",
        "  tmr::fd(k_robot, q, qd, u, gravity, qdd);",
        "}",
        "void tmr_rnea_grad(const double* q, const double* qd, const double* qdd,",
        "                   double gravity, double* dtau) {",
        "  tmr::rnea_grad(k_robot, q, qd, qdd, gravity, dtau);",
        "}",
        "void tmr_fd_grad(const double* q, const double* qd, const double* u,",
        "                 double gravity, double* out) {",
        "  tmr::fd_grad(k_robot, q, qd, u, gravity, out);",
        "}",
        "void tmr_aba(const double* q, const double* qd, const double* tau,",
        "             double gravity, double* qdd) {",
        "  tmr::aba(k_robot, q, qd, tau, gravity, qdd);",
        "}",
        "void tmr_idsva(const double* q, const double* qd, const double* qdd,",
        "               double gravity, double* dq, double* dqd) {",
        "  tmr::idsva(k_robot, q, qd, qdd, gravity, dq, dqd);",
        "}",
        "void tmr_idsva_noqdd(const double* q, const double* qd,",
        "                     double gravity, double* dq, double* dqd) {",
        "  tmr::idsva(k_robot, q, qd, nullptr, gravity, dq, dqd);",
        "}",
        "void tmr_ee_pos(const double* q, double* out3) {",
        "  tmr::ee_pos(k_robot, q, out3);",
        "}",
        "void tmr_ee_jacobian(const double* q, int kdim, double* J) {",
        "  tmr::ee_jacobian(k_robot, q, kdim, J);",
        "}",
        "}",
        "",
    ]
    return "\n".join(parts)


def build(robot: RobotModel, cache_dir: str | None = None) -> pathlib.Path:
    """Generate and compile the robot library; returns the .so path.  A
    library already built from the same source is reused; a new one is
    written under a temporary name and renamed into place, so a process
    never loads a half-written file."""
    src = generate_cpp(robot)
    key = hashlib.sha256(
        (src + _HEADER.read_text()).encode()).hexdigest()[:16]
    cache = pathlib.Path(cache_dir) if cache_dir else BUILD_ROOT
    cache.mkdir(parents=True, exist_ok=True)
    so = cache / f"{robot.name}_{key}.so"
    if so.exists():
        return so
    tmp = cache / f"{robot.name}_{key}.{os.getpid()}.tmp.so"
    with tempfile.TemporaryDirectory() as td:
        cpp = pathlib.Path(td) / "robot.cpp"
        cpp.write_text(src)
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC",
             "-o", str(tmp), str(cpp)],
            check=True, capture_output=True)
    os.replace(tmp, so)
    return so
