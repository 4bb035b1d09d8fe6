"""Port's robot models and conversions vs the JAX package, field by field.

The port copies models/robot.py and models/urdf.py (numpy only); these
tests hold the copies to the JAX package's RobotModel exactly (tolerance 0:
the same numpy arithmetic must give the same bits)."""

import dataclasses

import numpy as np
import pytest
import torch

from test_prismatic import _RPR_URDF
from trajoptmpcreference_tpu.models import urdf as jax_urdf
from trajoptmpcreference_tpu.solvers.sqp import SQPOptions as JaxSQPOptions
from trajoptmpcreference_tpu_torch import convert
from trajoptmpcreference_tpu_torch.models import urdf as torch_urdf
from trajoptmpcreference_tpu_torch.solvers.sqp import SQPOptions

# the in-test URDF strings of tests/test_urdf.py
_FIXED_URDF = """<?xml version="1.0"?>
<robot name="fixed_test">
  <link name="base"/>
  <joint name="j1" type="revolute">
    <parent link="base"/><child link="l1"/>
    <origin rpy="0 0 0" xyz="0 0 0"/><axis xyz="0 0 1"/>
  </joint>
  <link name="l1">
    <inertial><origin rpy="0 0 0" xyz="0 0.5 0"/><mass value="0.1"/>
      <inertia ixx="0.008" ixy="0" ixz="0" iyy="0.008" iyz="0" izz="0.0001"/>
    </inertial>
  </link>
  <joint name="jfix" type="fixed">
    <parent link="l1"/><child link="l2"/>
    <origin rpy="0 0 0" xyz="0 0.25 0"/>
  </joint>
  <link name="l2"/>
  <joint name="j2" type="revolute">
    <parent link="l2"/><child link="l3"/>
    <origin rpy="0 0 0" xyz="0 0.75 0"/><axis xyz="0 0 1"/>
  </joint>
  <link name="l3">
    <inertial><origin rpy="0 0 0" xyz="0 0.5 0"/><mass value="0.1"/>
      <inertia ixx="0.008" ixy="0" ixz="0" iyy="0.008" iyz="0" izz="0.0001"/>
    </inertial>
  </link>
</robot>"""

_INERTIAL = """<inertial><origin rpy="0 0 0" xyz="0 0.5 0"/>
      <mass value="0.1"/>
      <inertia ixx="0.008" ixy="0" ixz="0" iyy="0.008" iyz="0" izz="0.0001"/>
    </inertial>"""


def _j(name, p, c):
    return f"""<joint name="{name}" type="revolute">
    <parent link="{p}"/><child link="{c}"/>
    <origin rpy="0 0 0" xyz="0 1 0"/><axis xyz="0 0 1"/></joint>"""


_YTREE_URDF = f"""<?xml version="1.0"?>
<robot name="ytree">
  <link name="base"/>
  {_j("j0", "base", "l1")}<link name="l1">{_INERTIAL}</link>
  {_j("jA", "l1", "lA")}<link name="lA">{_INERTIAL}</link>
  {_j("jA2", "lA", "lA2")}<link name="lA2">{_INERTIAL}</link>
  {_j("jB", "l1", "lB")}<link name="lB">{_INERTIAL}</link>
</robot>"""

FIELDS = ("name", "parent", "joint_type", "axis", "X_fixed", "E_fixed",
          "t_fixed", "I_spatial", "damping")


def _assert_same_robot(port, ref):
    for f in FIELDS:
        a, b = getattr(port, f), getattr(ref, f)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            assert a == b, f
    assert port.n == ref.n
    np.testing.assert_array_equal(port.S, ref.S)
    assert port.leaves == ref.leaves
    assert port.is_serial_chain() == ref.is_serial_chain()
    for j in range(ref.n):
        assert port.subtree(j) == ref.subtree(j)
        assert port.ancestors(j) == ref.ancestors(j)


@pytest.mark.parametrize("n", [2, 3, 4, 5, 6])
def test_serial_arm_matches(n):
    _assert_same_robot(torch_urdf.serial_arm(n), jax_urdf.serial_arm(n))


@pytest.mark.parametrize("text", [_FIXED_URDF, _YTREE_URDF, _RPR_URDF],
                         ids=["fixed_joint", "ytree", "rpr_prismatic"])
def test_parse_urdf_matches(text, tmp_path):
    path = tmp_path / "robot.urdf"
    path.write_text(text)
    _assert_same_robot(torch_urdf.parse_urdf(str(path)),
                       jax_urdf.parse_urdf(str(path)))


@pytest.mark.parametrize("n", [2, 6])
def test_robot_from_numpy(n):
    """convert.robot_from_numpy(JAX RobotModel) equals the port's own."""
    converted = convert.robot_from_numpy(jax_urdf.serial_arm(n))
    assert converted == torch_urdf.serial_arm(n)
    _assert_same_robot(converted, jax_urdf.serial_arm(n))


def test_options_from_dict_is_total():
    """Every JAX SQPOptions field converts, values unchanged."""
    jopts = JaxSQPOptions(max_iter=3, alpha_min=0.11, alpha_factor=0.316,
                          parallel_line_search=True, ls_grad_at_base=True)
    opts = convert.options_from_dict(dataclasses.asdict(jopts))
    assert dataclasses.asdict(opts) == dataclasses.asdict(jopts)
    assert ({f.name for f in dataclasses.fields(SQPOptions)}
            == {f.name for f in dataclasses.fields(JaxSQPOptions)})
    with pytest.raises(ValueError):
        convert.options_from_dict({"no_such_field": 1})


def test_cost_params_from_numpy_batched_goal():
    rng = np.random.default_rng(0)
    xg = rng.standard_normal((3, 6))
    p = convert.cost_params_from_numpy(np.eye(6), 100 * np.eye(6),
                                       0.01 * np.eye(6), xg, device="cpu")
    assert p.xg.shape == (3, 6) and p.xg.dtype == torch.float64
    np.testing.assert_array_equal(p.xg.numpy(), xg)
