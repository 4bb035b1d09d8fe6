"""The CUDA kernels' arithmetic, compiled as plain C++ and run on the CPU.

kernels/csrc/*.cu guard their CUDA launch code with __CUDACC__; without it
each file compiles with g++ into a host loop over lanes that runs the very
same per-lane device functions.  This checks K1 / K2 / K3's recursions
against the port's plain PyTorch versions in f64 (atol 1e-9 on values up to
~1e3: the same recursions, sums reassociated) on serial arms of 1..7
joints, a branched tree and a prismatic joint.  It does not check that the
kernels build with nvcc or launch: chip_smoke.py does that on the card."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from test_prismatic import _RPR_URDF
from trajoptmpcreference_tpu_torch.kernels import _build
from trajoptmpcreference_tpu_torch.models.urdf import parse_urdf, serial_arm
from trajoptmpcreference_tpu_torch.ops import lanes
from trajoptmpcreference_tpu_torch.ops.kinematics import LaneKinematics

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no C++ toolchain")

_YTREE = """<?xml version="1.0"?><robot name="ytree"><link name="base"/>
{joints}</robot>"""


def _ytree(tmp_path):
    inertial = ('<inertial><origin rpy="0.3 0 0" xyz="0 0.5 0.1"/>'
                '<mass value="0.2"/><inertia ixx="0.008" ixy="0" ixz="0" '
                'iyy="0.006" iyz="0" izz="0.0001"/></inertial>')
    joints = ""
    for name, p, c, ax in (("j0", "base", "l1", "0 0 1"),
                           ("jA", "l1", "lA", "1 0 0"),
                           ("jA2", "lA", "lA2", "0 0 1"),
                           ("jB", "l1", "lB", "0 1 0")):
        joints += (f'<joint name="{name}" type="revolute"><parent link="{p}"/>'
                   f'<child link="{c}"/><origin rpy="0.1 0.2 0" xyz="0 1 0"/>'
                   f'<axis xyz="{ax}"/><dynamics damping="0.05"/></joint>'
                   f'<link name="{c}">{inertial}</link>')
    path = tmp_path / "ytree.urdf"
    path.write_text(_YTREE.format(joints=joints))
    return parse_urdf(str(path))


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    out = tmp_path_factory.mktemp("host_kernels")
    libs = {}
    procs = {}
    for name in _build.LIBRARIES:
        so = out / f"lib{name}.so"
        procs[name] = (subprocess.Popen(
            ["g++", "-x", "c++", "-std=c++17", "-O1", "-shared", "-fPIC",
             "-o", str(so), str(_build.CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, log
        lib = ctypes.CDLL(str(so))
        fn = getattr(lib, f"tmr_{name}_f64")
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def _robot(spec, tmp_path):
    if spec == "rpr":
        path = tmp_path / "rpr.urdf"
        path.write_text(_RPR_URDF)
        return parse_urdf(str(path))
    if spec == "ytree":
        return _ytree(tmp_path)
    return serial_arm(int(spec[3:]))


def _run(fn, robot, q, qd, u, shape):
    packed = lanes.pack_robot(robot, torch.float64, "cpu")
    out = torch.full(shape, float("nan"), dtype=torch.float64)
    rc = fn(q.data_ptr(), qd.data_ptr(), u.data_ptr(), packed.data_ptr(),
            out.data_ptr(), robot.n, q.shape[1], None)
    assert rc == 0
    return out


SPECS = ["arm1", "arm2", "arm3", "arm6", "arm7", "rpr", "ytree"]


@pytest.mark.parametrize("spec", SPECS)
def test_host_compiled_kernels_match_plain(spec, host_libs, tmp_path):
    robot = _robot(spec, tmp_path)
    n, L = robot.n, 11      # an odd lane count: no tiling assumption
    rng = np.random.default_rng(n)
    q, qd, u = (torch.tensor(rng.standard_normal((n, L))) for _ in range(3))
    fd = _run(host_libs["fd"], robot, q, qd, u, (n, L))
    np.testing.assert_allclose(fd, lanes.fd_lanes(robot, q, qd, u),
                               atol=1e-9, rtol=0)
    fdg = _run(host_libs["fd_grad"], robot, q, qd, u, (n, 3 * n, L))
    np.testing.assert_allclose(fdg, lanes.fd_grad_lanes(robot, q, qd, u),
                               atol=1e-9, rtol=0)
    kin = LaneKinematics(robot)
    tv = _run(host_libs["task_vec"], robot, q, qd, u, (2 * kin.k, L))
    np.testing.assert_allclose(tv, kin.task_vec_L(q, qd), atol=1e-12, rtol=0)
