"""Port's lanes dynamics (the plain versions of kernels K1 / K2) vs the JAX
package, and the CPU routing of the kernel wrappers.

Tolerances: f64 port vs JAX lanes at atol 1e-10 (same recursions, sums
reassociated); f32 plain versions vs the JAX Pallas kernels in interpret
mode at the JAX package's own bars (rel 1e-4, tests/test_lanes.py)."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_prismatic import _RPR_URDF
from trajoptmpcreference_tpu.models import urdf as jax_urdf
from trajoptmpcreference_tpu.ops import lanes as jlanes
from trajoptmpcreference_tpu_torch import convert
from trajoptmpcreference_tpu_torch.kernels import _build
from trajoptmpcreference_tpu_torch.ops import kinematics as tkin
from trajoptmpcreference_tpu_torch.ops import lanes as tlanes
from trajoptmpcreference_tpu_torch.utils import spans

ROBOTS = ["arm2", "arm3", "arm6", "rpr"]


def _jax_robot(name, tmp_path_factory):
    if name == "rpr":
        p = tmp_path_factory.mktemp("urdf") / "rpr.urdf"
        p.write_text(_RPR_URDF)
        return jax_urdf.parse_urdf(str(p))
    return jax_urdf.serial_arm(int(name[3:]))


@pytest.fixture(scope="module", params=ROBOTS)
def setup(request, tmp_path_factory):
    jrobot = _jax_robot(request.param, tmp_path_factory)
    n = jrobot.n
    rng = np.random.default_rng(7 + n)
    q, qd, u = (rng.standard_normal((n, 5)) for _ in range(3))
    return jrobot, convert.robot_from_numpy(jrobot), q, qd, u


def test_fd_lanes_matches_jax(setup):
    jrobot, robot, q, qd, u = setup
    ref = np.asarray(jlanes.fd_lanes(jrobot, *map(jnp.asarray, (q, qd, u))))
    out = tlanes.fd_lanes(robot, *map(torch.tensor, (q, qd, u))).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-10, rtol=0)


def test_fd_grad_lanes_matches_jax(setup):
    jrobot, robot, q, qd, u = setup
    ref = np.asarray(jlanes.fd_grad_lanes(jrobot, *map(jnp.asarray, (q, qd, u))))
    out = tlanes.fd_grad_lanes(robot, *map(torch.tensor, (q, qd, u))).numpy()
    assert out.shape == (robot.n, 3 * robot.n, 5)
    np.testing.assert_allclose(out, ref, atol=1e-10, rtol=0)


def _f32_inputs(seed, L):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((6, L)) * 0.3).astype(np.float32)
            for _ in range(3)]


def test_fd_plain_matches_pallas_fd_interpret():
    """K2's plain version (f32) vs the JAX Pallas fd kernel, interpreted:
    rel 1e-4 (tests/test_lanes.py::test_pallas_fd_interpret)."""
    q, qd, u = _f32_inputs(12, 256)
    ref = np.asarray(jlanes._pallas_fd(jax_urdf.serial_arm(6), -9.81,
                                       *map(jnp.asarray, (q, qd, u)),
                                       block_l=128, interpret=True))
    out = tlanes.fd_lanes(convert.robot_from_numpy(jax_urdf.serial_arm(6)),
                          *map(torch.tensor, (q, qd, u))).numpy()
    assert out.dtype == np.float32
    assert np.abs(out - ref).max() / np.abs(ref).max() < 1e-4


@pytest.mark.slow
def test_fd_grad_plain_matches_pallas_fd_grad_interpret():
    """K1's plain version (f32) vs the JAX Pallas fd_grad kernel,
    interpreted: rel 1e-4 (tests/test_lanes.py::test_pallas_fd_grad_interpret)."""
    q, qd, u = _f32_inputs(11, 128)
    ref = np.asarray(jlanes._pallas_fd_grad(jax_urdf.serial_arm(6), -9.81,
                                            *map(jnp.asarray, (q, qd, u)),
                                            block_l=64, interpret=True))
    out = tlanes.fd_grad_lanes(convert.robot_from_numpy(jax_urdf.serial_arm(6)),
                               *map(torch.tensor, (q, qd, u))).numpy()
    assert np.abs(out - ref).max() / np.abs(ref).max() < 1e-4


def test_cpu_tensors_take_the_plain_versions():
    """With every kernel flag on, CPU tensors never launch a kernel and
    give exactly the plain versions' values."""
    robot = convert.robot_from_numpy(jax_urdf.serial_arm(3))
    dyn = tlanes.LaneDynamics(robot, use_kernel_fd=True, use_kernel_fd_grad=True)
    kin = tkin.LaneKinematics(robot, use_kernel_task=True)
    counters = ("launch/fd", "launch/fd_grad", "launch/task_vec")
    before = [spans.count(k) for k in counters]
    q, qd, u = (torch.tensor(a) for a in _f32_inputs(3, 9))
    q, qd, u = q[:3].contiguous(), qd[:3].contiguous(), u[:3].contiguous()
    assert torch.equal(dyn.fd(q, qd, u), tlanes.fd_lanes(robot, q, qd, u))
    assert torch.equal(dyn.fd_grad(q, qd, u), tlanes.fd_grad_lanes(robot, q, qd, u))
    assert torch.equal(kin.task_vec(q, qd), kin.task_vec_L(q, qd))
    assert [spans.count(k) for k in counters] == before == [0, 0, 0]


def test_kernel_wrappers_reject_cpu_and_bad_operands():
    """A kernel wrapper launches on CUDA tensors or raises: never a silent
    CPU path."""
    robot = convert.robot_from_numpy(jax_urdf.serial_arm(3))
    packed = tlanes.pack_robot(robot, torch.float32, "cpu")
    q = torch.zeros((3, 8))
    with pytest.raises(ValueError, match="CUDA"):
        tlanes.fd_kernel(packed, 3, q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        tlanes.fd_grad_kernel(packed, 3, q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        tkin.task_vec_kernel(packed, 3, q, q)
    with pytest.raises(ValueError, match="joints"):
        tlanes.check_lanes(8, packed, torch.zeros((8, 4)))
    with pytest.raises(TypeError):
        tlanes.check_lanes(3, packed, torch.zeros((3, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="lanes"):
        tlanes.check_lanes(3, packed, torch.zeros((4, 4)))


def test_packed_layout_matches_cuda_header():
    """The Python packer and kernels/csrc/lanes_common.cuh agree on every
    offset of the packed robot buffer."""
    src = (_build.CSRC / "lanes_common.cuh").read_text()
    consts = dict(re.findall(r"\b(O_\w+|HEADER|JOINT_STRIDE) = (\d+)", src))
    assert int(consts["HEADER"]) == tlanes.HEADER
    assert int(consts["JOINT_STRIDE"]) == tlanes.JOINT_STRIDE
    for key, off in tlanes._OFF.items():
        assert int(consts[f"O_{key}"]) == off, key
    ends = sorted(tlanes._OFF.values())
    assert ends[-1] < tlanes.JOINT_STRIDE


def test_kernel_build_is_keyed_by_sources():
    """The build directory is ignored by git and keyed by a hash of csrc/."""
    d = _build.build_dir()
    assert d.parent == _build.BUILD_ROOT
    assert d.name == _build.source_hash() and len(d.name) == 16
    assert "-gencode" in _build.NVCC_FLAGS and "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
