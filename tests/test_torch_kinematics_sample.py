"""The port's per-sample kinematics (ops/kinematics.Kinematics) against the
JAX package's ``make_kinematics(use_lanes=False)``, in f64, and against the
port's LaneKinematics on the same states.

Inputs are numpy arrays from a seed; the JAX fields are jitted once per
robot and leaf (one program, vmapped over six samples) and the port takes
the same samples at batch shapes (), (5,) and (2, 3).  Robots: serial arms
of 2, 3 and 6 joints, the R-P-R arm, and a branched tree with the end
effector on each of its two leaves, at a non-default end-effector point.
Tolerances: 1e-12 of max|ref| (d2jdq2 1e-10: JAX's jacfwd and
torch.func.jacfwd differentiate the same recursions)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_prismatic import _RPR_URDF
from test_torch_kernel_sources import _ytree
from trajoptmpcreference_tpu.models import urdf as jax_urdf
from trajoptmpcreference_tpu.ops.kinematics import make_kinematics as jax_make_kinematics
from trajoptmpcreference_tpu_torch import convert
from trajoptmpcreference_tpu_torch.ops.kinematics import (
    Kinematics,
    LaneKinematics,
    make_kinematics,
)

CONFIGS = ["arm2", "arm3", "arm6", "rpr", "ytree:0", "ytree:1"]
SHAPES = [(), (5,), (2, 3)]
OFFSET = (0.1, 0.8, -0.2)
FIELDS_Q = ["ee_pos_xyz", "ee_pos", "jacobian", "djdq", "d2jdq2"]
FIELDS_QQD = ["jacobian_tot_state", "task_vec"]
TOL = {"d2jdq2": 1e-10}


def _robots(spec, tmp_path_factory):
    """(JAX robot, port robot, leaf) for a config name."""
    name, _, leaf = spec.partition(":")
    tmp = tmp_path_factory.mktemp("urdf")
    if name == "rpr":
        (tmp / "rpr.urdf").write_text(_RPR_URDF)
        jrobot = jax_urdf.parse_urdf(str(tmp / "rpr.urdf"))
    elif name == "ytree":
        _ytree(tmp)
        jrobot = jax_urdf.parse_urdf(str(tmp / "ytree.urdf"))
    else:
        jrobot = jax_urdf.serial_arm(int(name[3:]))
    return jrobot, convert.robot_from_numpy(jrobot), int(leaf or 0)


@pytest.fixture(scope="module", params=CONFIGS)
def setup(request, tmp_path_factory):
    jrobot, robot, leaf = _robots(request.param, tmp_path_factory)
    n = robot.n
    rng = np.random.default_rng(31 + n + leaf)
    q, qd = rng.standard_normal((2, 6, n))
    jkin = jax_make_kinematics(jrobot, offset=OFFSET, leaf=leaf)

    def fields(qq, qqd):
        out = {f: getattr(jkin, f)(qq) for f in FIELDS_Q}
        out.update({f: getattr(jkin, f)(qq, qqd) for f in FIELDS_QQD})
        out["frames p"], out["frames w"], out["frames o"] = jkin.frames(qq)
        return out

    ref = jax.jit(jax.vmap(fields))(jnp.asarray(q), jnp.asarray(qd))
    kin = make_kinematics(robot, offset=OFFSET, leaf=leaf)
    return robot, leaf, kin, {k: np.asarray(v) for k, v in ref.items()}, q, qd


def _at(a, shape):
    size = int(np.prod(shape))
    return a[:size].reshape(shape + a.shape[1:])


@pytest.mark.parametrize("field", FIELDS_Q + FIELDS_QQD + ["frames"])
def test_kinematics_field_matches_jax(setup, field):
    robot, _, kin, ref, q, qd = setup
    assert isinstance(kin, Kinematics) and kin.plain is kin
    for shape in SHAPES:
        tq, tqd = torch.tensor(_at(q, shape)), torch.tensor(_at(qd, shape))
        if field == "frames":
            outs = dict(zip(("frames p", "frames w", "frames o"), kin.frames(tq)))
        elif field in FIELDS_Q:
            outs = {field: getattr(kin, field)(tq)}
        else:
            outs = {field: getattr(kin, field)(tq, tqd)}
        for name, out in outs.items():
            r = _at(ref[name], shape)
            assert out.shape == r.shape, (name, shape, out.shape, r.shape)
            scale = max(np.abs(r).max(), 1e-300)
            rel = np.abs(out.numpy() - r).max() / scale
            assert rel < TOL.get(field, 1e-12), (name, shape, rel)


def test_state_methods_match_fields(setup):
    """The state-level methods the costs call (x (..., 2n)) are the
    per-sample fields at x's halves."""
    robot, _, kin, _, q, qd = setup
    x = torch.tensor(np.concatenate([q, qd], -1).reshape(2, 3, -1))
    tq, tqd = x[..., :robot.n], x[..., robot.n:]
    assert torch.equal(kin.task_vec_x(x), kin.task_vec(tq, tqd))
    assert torch.equal(kin.jacobian_tot_state_x(x),
                       kin.jacobian_tot_state(tq, tqd))
    assert torch.equal(kin.jacobian_x(x), kin.jacobian(tq))
    assert torch.equal(kin.ee_pos_x(x), kin.ee_pos(tq))


def test_lane_kinematics_matches_per_sample(setup):
    """LaneKinematics (lanes layout, its plain versions on the CPU) against
    the per-sample Kinematics on the same states, and its ``plain`` is the
    per-sample Kinematics of its chain."""
    robot, leaf, kin, _, q, qd = setup
    lk = make_kinematics(robot, offset=OFFSET, leaf=leaf, use_lanes=True)
    assert isinstance(lk, LaneKinematics) and isinstance(lk.plain, Kinematics)
    assert (lk.plain.offset, lk.plain.leaf) == (kin.offset, kin.leaf)
    tq, tqd = torch.tensor(q), torch.tensor(qd)
    lq, lqd = tq.T.contiguous(), tqd.T.contiguous()
    pairs = {
        "ee_pos_xyz": (lk.ee_pos_xyz(lq), kin.ee_pos_xyz(tq)),
        "ee_pos": (lk.ee_pos(lq), kin.ee_pos(tq)),
        "jacobian": (lk.jacobian(lq), kin.jacobian(tq)),
        "djdq": (lk.djdq_L(lq), kin.djdq(tq)),
        "jacobian_tot_state": (lk.jacobian_tot_state(lq, lqd),
                               kin.jacobian_tot_state(tq, tqd)),
        "task_vec": (lk.task_vec(lq, lqd), kin.task_vec(tq, tqd)),
    }
    for name, (lanes_out, ref) in pairs.items():
        out = lanes_out.movedim(-1, 0)
        assert out.shape == ref.shape, (name, out.shape, ref.shape)
        rel = float((out - ref).abs().max() / ref.abs().max())
        assert rel < 1e-12, (name, rel)
    x = torch.cat([tq, tqd], -1)
    for name in ("task_vec_x", "jacobian_tot_state_x", "jacobian_x", "ee_pos_x"):
        out, ref = getattr(lk, name)(x), getattr(kin, name)(x)
        assert out.shape == ref.shape, name
        assert float((out - ref).abs().max() / ref.abs().max()) < 1e-12, name


def test_d2jdq2_matches_autodiff():
    """d2jdq2 against a triple torch.func.jacfwd of the end-effector point
    (tests/test_rbd.py::test_d2jdq2_matches_autodiff), for a batch."""
    kin = make_kinematics(convert.robot_from_numpy(jax_urdf.serial_arm(3)))
    q = torch.tensor(np.random.default_rng(9).standard_normal((2, 3)))
    dd = kin.d2jdq2(q)
    f = torch.func.jacfwd(torch.func.jacfwd(torch.func.jacfwd(
        lambda qq: kin.ee_pos_xyz(qq)[:3])))
    dd_ad = torch.func.vmap(f)(q)
    np.testing.assert_allclose(dd.numpy(), dd_ad.numpy(), atol=1e-11)
