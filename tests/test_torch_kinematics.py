"""Port's lanes kinematics (the plain version of kernel K3) vs the JAX
package's lanes kinematics.

Tolerances: f64 at atol 1e-12 (the same geometric recursions); the f32
plain task residual vs the JAX Pallas task kernel in interpret mode at
rel 1e-5 (the JAX package's own bar, tests/test_lanes.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_prismatic import _RPR_URDF
from trajoptmpcreference_tpu.models import urdf as jax_urdf
from trajoptmpcreference_tpu.ops.kinematics import make_kinematics
from trajoptmpcreference_tpu_torch import convert
from trajoptmpcreference_tpu_torch.ops.kinematics import LaneKinematics

ROBOTS = ["arm2", "arm3", "arm6", "rpr"]


@pytest.fixture(scope="module", params=ROBOTS)
def setup(request, tmp_path_factory):
    if request.param == "rpr":
        p = tmp_path_factory.mktemp("urdf") / "rpr.urdf"
        p.write_text(_RPR_URDF)
        jrobot = jax_urdf.parse_urdf(str(p))
    else:
        jrobot = jax_urdf.serial_arm(int(request.param[3:]))
    n = jrobot.n
    rng = np.random.default_rng(3 + n)
    q, qd = rng.standard_normal((n, 7)), rng.standard_normal((n, 7))
    jkin = make_kinematics(jrobot, use_lanes=True)
    kin = LaneKinematics(convert.robot_from_numpy(jrobot))
    return jkin, kin, q, qd


def _lanes_of(fn, *args, out_axes):
    """JAX per-sample kinematics vmapped over the lane axis."""
    return np.asarray(jax.vmap(fn, in_axes=1, out_axes=out_axes)(
        *map(jnp.asarray, args)))


def test_task_vec_matches_jax(setup):
    jkin, kin, q, qd = setup
    ref = _lanes_of(jkin.task_vec, q, qd, out_axes=1)
    out = kin.task_vec(torch.tensor(q), torch.tensor(qd)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-12, rtol=0)


def test_jacobian_tot_state_matches_jax(setup):
    jkin, kin, q, qd = setup
    ref = _lanes_of(jkin.jacobian_tot_state, q, qd, out_axes=2)
    out = kin.jacobian_tot_state(torch.tensor(q), torch.tensor(qd)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-12, rtol=0)


def test_ee_pos_xyz_and_jacobian_match_jax(setup):
    jkin, kin, q, qd = setup
    np.testing.assert_allclose(
        kin.ee_pos_xyz(torch.tensor(q)).numpy(),
        _lanes_of(jkin.ee_pos_xyz, q, out_axes=1), atol=1e-12, rtol=0)
    np.testing.assert_allclose(
        kin.jacobian(torch.tensor(q)).numpy(),
        _lanes_of(jkin.jacobian, q, out_axes=2), atol=1e-12, rtol=0)


def test_task_vec_plain_matches_pallas_task_vec_interpret():
    """K3's plain version (f32) vs the JAX Pallas task kernel, interpreted:
    rel 1e-5 (tests/test_lanes.py::test_pallas_task_vec_interpret)."""
    robot = jax_urdf.serial_arm(6)
    rng = np.random.default_rng(13)
    q = (rng.standard_normal((256, 6)) * 0.3).astype(np.float32)
    qd = (rng.standard_normal((256, 6)) * 0.3).astype(np.float32)
    kin_p = make_kinematics(robot, use_lanes=True, use_pallas_task=True,
                            pallas_interpret=True)
    ref = np.asarray(jax.vmap(kin_p.task_vec)(jnp.asarray(q), jnp.asarray(qd)))
    kin = LaneKinematics(convert.robot_from_numpy(robot))
    out = kin.task_vec_L(torch.tensor(q.T.copy()), torch.tensor(qd.T.copy()))
    assert out.dtype == torch.float32
    rel = np.abs(out.numpy().T - ref).max() / np.abs(ref).max()
    assert rel < 1e-5
