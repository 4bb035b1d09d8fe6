"""The CUDA kernels' arithmetic, compiled as plain C++ and run on the CPU.

kernels/csrc/*.cu guard their CUDA launch code with __CUDACC__; without it
each file compiles with g++ into a host loop (over lanes, or over scenarios
with one serial "thread" per block) that runs the very same device
functions.  This checks K1 / K2 / K3's recursions against the port's plain
PyTorch versions in f64 (atol 1e-9 on values up to ~1e3: the same
recursions, sums reassociated) on serial arms of 1..7 joints, a branched
tree and a prismatic joint; and K4's PCG against ``pcg_fused_plain`` in
f64 (1e-10 of the solution's scale, equal iteration counts: the same loop,
reductions in another order).  It does not check that the kernels build
with nvcc or launch: chip_smoke.py does that on the card."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from test_prismatic import _RPR_URDF
from trajoptmpcreference_tpu_torch.kernels import _build
from trajoptmpcreference_tpu_torch.models.urdf import parse_urdf, serial_arm
from trajoptmpcreference_tpu_torch.ops import btridiag as tbtd
from trajoptmpcreference_tpu_torch.ops import fused_pcg as FP
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
        fn.argtypes = _build.ARGTYPES[name]
        fn.restype = ctypes.c_int
        libs[name] = fn
        if name == "pcg":
            libs["pcg_smem_elems"] = lib.tmr_pcg_smem_elems
            lib.tmr_pcg_smem_elems.argtypes = [ctypes.c_int, ctypes.c_int]
            lib.tmr_pcg_smem_elems.restype = ctypes.c_longlong
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


def _pcg_problem(B, N, bs, seed, precond):
    """Packed K4 operands for B random systems (scenario 1 negative
    definite, scenario 0's r0 exactly zero: converged before the first
    iteration) with right-hand sides of scales 1e-2..1e2."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((B, N, bs, bs))
    sign = np.where(np.arange(B) == 1, -1.0, 1.0)[:, None, None, None]
    diag = sign * (M @ np.swapaxes(M, -1, -2) + 4.0 * bs * np.eye(bs))
    upper = sign * 0.3 * rng.standard_normal((B, N - 1, bs, bs))
    r0 = rng.standard_normal((B, N, bs)) * np.logspace(-2, 2, B)[:, None, None]
    r0[0] = 0.0
    A = tbtd.BlockTridiag(torch.tensor(diag), torch.tensor(upper))
    return FP.pack_operands(A, torch.tensor(r0), precond)


@pytest.mark.parametrize("N", [1, 7, 64])
@pytest.mark.parametrize("relative", [False, True])
@pytest.mark.parametrize("precond", ["J", "BJ", "SS"])
def test_host_compiled_pcg_matches_plain(precond, relative, N, host_libs):
    B, bs, max_iter = 4, 12, 60
    tol = 1e-14 if relative else 1e-10
    ops = _pcg_problem(B, N, bs, seed=N, precond=precond)
    dx = torch.full_like(ops[3], float("nan"))
    iters = torch.full((B,), -1, dtype=torch.int32)
    rc = host_libs["pcg"](*(t.data_ptr() for t in ops), dx.data_ptr(),
                          iters.data_ptr(), B, N, bs, int(precond == "SS"),
                          int(relative), max_iter, tol, None)
    assert rc == 0
    ref, ref_iters = FP.pcg_fused_plain(*ops, precond=precond, tol=tol,
                                        max_iter=max_iter, relative=relative)
    assert iters.tolist() == ref_iters.tolist()
    assert iters[0] == 0 and torch.equal(dx[0], torch.zeros_like(dx[0]))
    for k in range(1, B):
        np.testing.assert_allclose(dx[k].numpy(), ref[k].numpy(), rtol=0,
                                   atol=1e-10 * float(ref[k].abs().max()))


def test_host_compiled_pcg_shared_memory_size(host_libs):
    """The kernel's shared-memory carve equals the wrapper's estimate."""
    for N, bs in ((1, 1), (7, 12), (64, 12), (63, 5)):
        elems = host_libs["pcg_smem_elems"](N, bs)
        assert FP.smem_bytes(N, bs, torch.float64) == 8 * elems
        assert FP.smem_bytes(N, bs, torch.float32) == 4 * elems
