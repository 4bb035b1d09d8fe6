"""The port's per-sample rigid-body dynamics and spatial algebra
(ops/rbd.py, ops/spatial.py) against the JAX package's, in f64.

Inputs are numpy arrays from a seed.  Each JAX function is jitted once per
robot (one program computing every output, vmapped over six samples);
the port takes the same samples at batch shapes (), (5,) and (2, 3).
Tolerances: every RBD output under 1e-12 of max|ref| (the same
recursions, products summed in another order); the cross-identities
(CRBA Minv = I, ABA = fd, the RNEA round trip, IDSVA = rnea_grad) at the
JAX package's own bars (tests/test_rbd.py); the port's rbd.fd / fd_grad
against its lanes plain versions under 1e-12."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_prismatic import _RPR_URDF
from trajoptmpcreference_tpu.models import urdf as jax_urdf
from trajoptmpcreference_tpu.ops import spatial as jspatial
from trajoptmpcreference_tpu.ops.rbd import make_rbd as jax_make_rbd
from trajoptmpcreference_tpu_torch import convert
from trajoptmpcreference_tpu_torch.models.urdf import serial_arm
from trajoptmpcreference_tpu_torch.ops import lanes
from trajoptmpcreference_tpu_torch.ops import spatial
from trajoptmpcreference_tpu_torch.ops.rbd import make_rbd

ROBOTS = ["arm2", "arm3", "arm6", "rpr"]
SHAPES = [(), (5,), (2, 3)]
GRAVITY = -3.7          # a non-default gravity
TOL = 1e-12


def _jax_robot(name, tmp_path_factory):
    if name == "rpr":
        p = tmp_path_factory.mktemp("urdf") / "rpr.urdf"
        p.write_text(_RPR_URDF)
        return jax_urdf.parse_urdf(str(p))
    return jax_urdf.serial_arm(int(name[3:]))


def _jax_outputs(jrbd):
    """Every RBD output of one sample, as one function to jit."""
    def outputs(q, qd, u, qdd):
        c, v, a, f = jrbd.rnea(q, qd, qdd)
        cg, vg, ag, fg = jrbd.rnea(q, qd, None, gravity=GRAVITY, use_damping=True)
        dq, dqd = jrbd.idsva(q, qd, qdd, gravity=GRAVITY)
        return {
            "rnea c": c, "rnea v": v, "rnea a": a, "rnea f": f,
            "rnea c (g, damping, no qdd)": cg, "rnea v (g, damping, no qdd)": vg,
            "rnea a (g, damping, no qdd)": ag, "rnea f (g, damping, no qdd)": fg,
            "rnea_grad": jrbd.rnea_grad(q, qd, qdd),
            "rnea_grad (g, damping)": jrbd.rnea_grad(q, qd, qdd, GRAVITY, True),
            "minv": jrbd.minv(q),
            "minv (not dense)": jrbd.minv(q, output_dense=False),
            "crba": jrbd.crba(q),
            "aba (g)": jrbd.aba(q, qd, u, GRAVITY),
            "idsva dq (g)": dq, "idsva dqd (g)": dqd,
            "fd": jrbd.fd(q, qd, u),
            "fd_grad": jrbd.fd_grad(q, qd, u),
        }
    return outputs


def _port_outputs(rbd, q, qd, u, qdd):
    c, v, a, f = rbd.rnea(q, qd, qdd)
    cg, vg, ag, fg = rbd.rnea(q, qd, None, gravity=GRAVITY, use_damping=True)
    dq, dqd = rbd.idsva(q, qd, qdd, gravity=GRAVITY)
    return {
        "rnea c": c, "rnea v": v, "rnea a": a, "rnea f": f,
        "rnea c (g, damping, no qdd)": cg, "rnea v (g, damping, no qdd)": vg,
        "rnea a (g, damping, no qdd)": ag, "rnea f (g, damping, no qdd)": fg,
        "rnea_grad": rbd.rnea_grad(q, qd, qdd),
        "rnea_grad (g, damping)": rbd.rnea_grad(q, qd, qdd, GRAVITY, True),
        "minv": rbd.minv(q),
        "minv (not dense)": rbd.minv(q, output_dense=False),
        "crba": rbd.crba(q),
        "aba (g)": rbd.aba(q, qd, u, GRAVITY),
        "idsva dq (g)": dq, "idsva dqd (g)": dqd,
        "fd": rbd.fd(q, qd, u),
        "fd_grad": rbd.fd_grad(q, qd, u),
    }


OUTPUTS = ["rnea c", "rnea v", "rnea a", "rnea f",
           "rnea c (g, damping, no qdd)", "rnea v (g, damping, no qdd)",
           "rnea a (g, damping, no qdd)", "rnea f (g, damping, no qdd)",
           "rnea_grad", "rnea_grad (g, damping)", "minv", "minv (not dense)",
           "crba", "aba (g)", "idsva dq (g)", "idsva dqd (g)", "fd", "fd_grad"]


@pytest.fixture(scope="module", params=ROBOTS)
def setup(request, tmp_path_factory):
    jrobot = _jax_robot(request.param, tmp_path_factory)
    n = jrobot.n
    rng = np.random.default_rng(2024 + n)
    q, qd, u, qdd = (rng.standard_normal((6, n)) for _ in range(4))
    ref = jax.jit(jax.vmap(_jax_outputs(jax_make_rbd(jrobot))))(
        *map(jnp.asarray, (q, qd, u, qdd)))
    robot = convert.robot_from_numpy(jrobot)
    ports = {}
    rbd = make_rbd(robot)
    for shape in SHAPES:
        size = int(np.prod(shape))
        args = [torch.tensor(a[:size].reshape(shape + (n,)))
                for a in (q, qd, u, qdd)]
        ports[shape] = _port_outputs(rbd, *args)
    return robot, {k: np.asarray(v) for k, v in ref.items()}, ports, (q, qd, u)


@pytest.mark.parametrize("name", OUTPUTS)
def test_rbd_matches_jax(setup, name):
    """Each RBD output against JAX make_rbd at every batch shape."""
    _, ref, ports, _ = setup
    for shape, out in ports.items():
        size = int(np.prod(shape))
        r = ref[name][:size].reshape(shape + ref[name].shape[1:])
        o = out[name].numpy()
        assert o.shape == r.shape, (name, shape, o.shape, r.shape)
        rel = np.abs(o - r).max() / np.abs(r).max()
        assert rel < TOL, (name, shape, rel)


def test_spatial_identities():
    """tests/test_rbd.py::test_spatial_identities, with the port's
    operators also held element by element to the JAX package's."""
    rng = np.random.default_rng(0)
    a_np, b_np = rng.standard_normal(6), rng.standard_normal(6)
    a, b = torch.tensor(a_np), torch.tensor(b_np)
    np.testing.assert_allclose(spatial.crm(a) @ b, -(spatial.crm(b) @ a),
                               atol=1e-14)
    np.testing.assert_allclose(spatial.crf(a) @ b, spatial.icrf(b) @ a,
                               atol=1e-14)
    for name in ("crm", "crf", "icrf"):
        np.testing.assert_array_equal(
            getattr(spatial, name)(a).numpy(),
            np.asarray(getattr(jspatial, name)(jnp.asarray(a_np))))
    S = torch.tensor(rng.standard_normal(6))
    for name in ("mxS", "fxS"):
        np.testing.assert_allclose(
            getattr(spatial, name)(S, a, 0.7).numpy(),
            np.asarray(getattr(jspatial, name)(jnp.asarray(S.numpy()),
                                               jnp.asarray(a_np), 0.7)),
            atol=1e-14, rtol=0)
    Imat = rng.standard_normal((6, 6))
    np.testing.assert_allclose(
        spatial.vxIv(a, torch.tensor(Imat)).numpy(),
        np.asarray(jspatial.vxIv(jnp.asarray(a_np), jnp.asarray(Imat))),
        atol=1e-13, rtol=0)
    E = spatial.joint_free_rotation(np.array([0.0, 0.0, 1.0]),
                                    torch.tensor(0.7, dtype=torch.float64))
    Z = torch.zeros(3, 3, dtype=torch.float64)
    Xr = torch.cat([torch.cat([E, Z], 1), torch.cat([Z, E], 1)], 0)
    Xt = torch.eye(6, dtype=torch.float64)
    Xt[3:, :3] = -spatial._skew(torch.tensor(rng.standard_normal(3)))
    X = Xr @ Xt
    np.testing.assert_allclose(spatial.spatial_inv(X) @ X, np.eye(6),
                               atol=1e-13)


@pytest.mark.parametrize("name", ["arm6", "rpr"])
def test_joint_transforms_match_jax(name, tmp_path_factory):
    """joint_transforms and joint_hom_transform (revolute and prismatic)
    at batch shapes (), (5,) and (2, 3)."""
    jrobot = _jax_robot(name, tmp_path_factory)
    robot = convert.robot_from_numpy(jrobot)
    n = robot.n
    q = np.random.default_rng(5).standard_normal((6, n))
    refX = np.asarray(jax.vmap(lambda qq: jspatial.joint_transforms(jrobot, qq))(
        jnp.asarray(q)))
    refH = [np.asarray(jax.vmap(lambda t, j=j: jspatial.joint_hom_transform(
        jrobot, j, t))(jnp.asarray(q[:, j]))) for j in range(n)]
    for shape in SHAPES:
        size = int(np.prod(shape))
        qt = torch.tensor(q[:size].reshape(shape + (n,)))
        X = spatial.joint_transforms(robot, qt).numpy()
        np.testing.assert_allclose(
            X, refX[:size].reshape(shape + (n, 6, 6)), atol=1e-14, rtol=0)
        for j in range(n):
            H = spatial.joint_hom_transform(robot, j, qt[..., j]).numpy()
            np.testing.assert_allclose(
                H, refH[j][:size].reshape(shape + (4, 4)), atol=1e-14, rtol=0)


def test_crba_inverts_minv(setup):
    """tests/test_rbd.py::test_crba_inverts_minv: H Minv = I, both symmetric."""
    robot, _, ports, _ = setup
    out = ports[(2, 3)]
    H, Mi = out["crba"], out["minv"]
    eye = np.broadcast_to(np.eye(robot.n), H.shape)
    np.testing.assert_allclose(H @ Mi, eye, atol=1e-10)
    np.testing.assert_allclose(H, H.transpose(-1, -2), atol=1e-12)
    np.testing.assert_allclose(Mi, Mi.transpose(-1, -2), atol=1e-12)


def test_aba_matches_fd(setup):
    """ABA = Minv (u - c) (tests/test_rbd.py::test_aba_matches_minv_fd),
    at the default gravity and another."""
    robot, _, _, (q, qd, u) = setup
    rbd = make_rbd(robot)
    q, qd, u = map(torch.tensor, (q, qd, u))
    for g in (-9.81, GRAVITY):
        np.testing.assert_allclose(rbd.aba(q, qd, u, g), rbd.fd(q, qd, u, g),
                                   atol=1e-10)


def test_rnea_inverts_fd(setup):
    """tau = RNEA(q, qd, FD(q, qd, tau))."""
    robot, _, _, (q, qd, u) = setup
    rbd = make_rbd(robot)
    q, qd, u = map(torch.tensor, (q, qd, u))
    for g in (-9.81, GRAVITY):
        qdd = rbd.fd(q, qd, u, g)
        np.testing.assert_allclose(rbd.rnea(q, qd, qdd, g)[0], u, atol=1e-10)


def test_rnea_grad_matches_autodiff_and_idsva(setup):
    """The analytic RNEA gradient against torch.func.jacfwd of rnea, and
    IDSVA against it (tests/test_rbd.py:68-125)."""
    robot, _, ports, (q, qd, u) = setup
    rbd = make_rbd(robot)
    n = robot.n
    q, qd, u = map(torch.tensor, (q, qd, u))
    qdd = rbd.fd(q, qd, u)

    def tau(z, qdd_i):
        return rbd.rnea(z[:n], z[n:], qdd_i)[0]

    J_auto = torch.func.vmap(torch.func.jacfwd(tau))(torch.cat([q, qd], -1), qdd)
    J_ana = rbd.rnea_grad(q, qd, qdd)
    np.testing.assert_allclose(J_ana, J_auto, atol=1e-10)
    dq, dqd = rbd.idsva(q, qd, qdd)
    np.testing.assert_allclose(dq, J_ana[..., :n], atol=1e-9)
    np.testing.assert_allclose(dqd, J_ana[..., n:], atol=1e-9)

    def fd_flat(z):
        return rbd.fd(z[:n], z[n:2 * n], z[2 * n:])

    J_fd = torch.func.vmap(torch.func.jacfwd(fd_flat))(torch.cat([q, qd, u], -1))
    np.testing.assert_allclose(rbd.fd_grad(q, qd, u), J_fd, atol=1e-9)


def test_gravity_free_energy_conservation():
    """0.5 qd^T H qd is conserved under zero torque and zero gravity
    (tests/test_rbd.py::test_gravity_free_energy_conservation), here for a
    batch of two states."""
    rbd = make_rbd(serial_arm(3))
    q = torch.tensor([[0.3, -0.4, 0.2], [-0.1, 0.5, 0.3]], dtype=torch.float64)
    qd = torch.tensor([[0.5, 0.1, -0.2], [0.2, -0.3, 0.1]], dtype=torch.float64)
    u = torch.zeros_like(q)
    dt = 1e-4

    def energy(q, qd):
        return 0.5 * (qd[..., None, :] @ rbd.crba(q) @ qd[..., :, None])[..., 0, 0]

    e0 = energy(q, qd)
    for _ in range(100):
        qdd = rbd.aba(q, qd, u, gravity=0.0)
        q, qd = q + dt * qd, qd + dt * qdd
    assert float((energy(q, qd) - e0).abs().max()) < 1e-5


@pytest.mark.parametrize("name", ROBOTS)
def test_rbd_matches_lanes_plain_versions(name, tmp_path_factory):
    """rbd.fd / fd_grad against the lanes plain versions fd_lanes /
    fd_grad_lanes (the plain versions of K2 and K1) on the same states:
    two formulations of one function, under 1e-12 of max|ref|."""
    robot = convert.robot_from_numpy(_jax_robot(name, tmp_path_factory))
    n = robot.n
    rng = np.random.default_rng(77 + n)
    q, qd, u = (torch.tensor(rng.standard_normal((9, n))) for _ in range(3))
    rbd = make_rbd(robot)
    lanes_of = lambda t: t.T.contiguous()
    qdd_l = lanes.fd_lanes(robot, *map(lanes_of, (q, qd, u)))
    d_l = lanes.fd_grad_lanes(robot, *map(lanes_of, (q, qd, u)))
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
    assert rel(rbd.fd(q, qd, u), qdd_l.T) < TOL
    assert rel(rbd.fd_grad(q, qd, u), d_l.permute(2, 0, 1)) < TOL
