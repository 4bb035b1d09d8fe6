"""The port's per-sample URDF plant (``URDFPlant(use_lanes=False)``: ops/rbd.py
and the per-sample kinematics) against the JAX package's, against the
port's lanes plant, and in the solvers, in f64 on the CPU.

* xdot, dxdot, step and step_gradient for integrators 0-4 against JAX
  ``URDFPlant(use_lanes=False)`` (jitted once per integrator, vmapped) and
  against the lanes plant: 1e-12 of max|ref|.
* ``options``, ``get_num_*``, and the kernel flags unread without lanes.
* UrdfCost on the per-sample plant (tests/test_costs.py:35) against JAX's
  on its per-sample plant, Hessian modes 0-3: 1e-10 (as
  tests/test_torch_costs_more.py); the exact Hessian against
  torch.func.hessian of the value.
* The arm2 method-S solve on the per-sample plant against the reference's
  golden arm2_S.npz, as tests/test_sqp_parity.py:70-83 holds it (1e-9).
* A flagship episode (B = 4, N = 16, 10 steps, f64), per-sample against
  lanes: equal iterations and exit codes, the cold step's controls under
  1e-9, and the whole loop under 3x the gap that moving the lanes plant's
  fd_grad by one ulp makes to the lanes loop itself (from its first
  steady step the loop amplifies rounding far past 1e-9, so two
  formulations of the dynamics can agree no closer); a fault of 1e-8
  planted in the per-sample fd_grad must read above that bar.
"""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_kernel_sources import _ytree
from trajoptmpcreference_tpu.models import plants as JP
from trajoptmpcreference_tpu.models import urdf as jax_urdf
from trajoptmpcreference_tpu.solvers import costs as JCost
from trajoptmpcreference_tpu_torch import convert
from trajoptmpcreference_tpu_torch import flagship as F
from trajoptmpcreference_tpu_torch.models import plants as TP
from trajoptmpcreference_tpu_torch.models.urdf import serial_arm
from trajoptmpcreference_tpu_torch.ops import lanes
from trajoptmpcreference_tpu_torch.ops.kinematics import Kinematics
from trajoptmpcreference_tpu_torch.solvers import costs as TCost
from trajoptmpcreference_tpu_torch.solvers.sqp import SQPOptions, make_sqp

GOLDEN = pathlib.Path(__file__).parent / "golden"
DT = 0.05
f64 = torch.float64


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and under several test workers torch's thread pool only contends with
    the other workers' (a closed loop here ran ~30x its one-process time
    under the six-worker tier-1 run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.tensor(np.asarray(a), dtype=f64)


@pytest.fixture(scope="module")
def ytree(tmp_path_factory):
    """The branched tree (axes along x, y and z, damped joints), whose
    dynamics gravity reaches: its URDF path and the JAX robot."""
    tmp = tmp_path_factory.mktemp("urdf")
    _ytree(tmp)
    path = str(tmp / "ytree.urdf")
    return path, jax_urdf.parse_urdf(path)


@pytest.fixture(scope="module")
def states():
    rng = np.random.default_rng(21)
    return rng.standard_normal((6, 4)), rng.standard_normal((6, 2))


@pytest.fixture(scope="module")
def jax_dynamics(states):
    """JAX xdot / dxdot, and step / step_gradient per integrator, of the
    per-sample 2-joint arm at the six states."""
    jrobot = jax_urdf.serial_arm(2)
    x, u = map(jnp.asarray, states)
    out = {}
    for itype in range(5):
        jp = JP.URDFPlant(robot=jrobot, use_lanes=False, integrator_type=itype)
        fns = lambda xx, uu: (jp.step(xx, uu, DT), *jp.step_gradient(xx, uu, DT))
        out[itype] = [np.asarray(a) for a in jax.jit(jax.vmap(fns))(x, u)]
    out["xdot"] = np.asarray(jax.jit(jax.vmap(jp.xdot))(x, u))
    out["dxdot"] = np.asarray(jax.jit(jax.vmap(jp.dxdot))(x, u))
    return out


def _rel(out, ref):
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return float(np.abs(out.numpy() - ref).max() / max(np.abs(ref).max(), 1e-300))


@pytest.mark.parametrize("itype", range(5))
def test_plant_matches_jax_and_lanes(itype, states, jax_dynamics):
    """xdot, dxdot, step and step_gradient against the JAX per-sample plant
    (batch shape (2, 3)) and against the port's lanes plant."""
    robot = serial_arm(2)
    plant = TP.URDFPlant(robot=robot, use_lanes=False, integrator_type=itype)
    lanes_plant = TP.URDFPlant(robot=robot, integrator_type=itype)
    assert plant.dynamics is None and isinstance(plant.kinematics, Kinematics)
    x, u = (t(a).reshape(2, 3, -1) for a in states)
    ref = jax_dynamics
    A, Bm = plant.step_gradient(x, u, DT)
    outs = {"xdot": (plant.xdot(x, u), ref["xdot"]),
            "dxdot": (plant.dxdot(x, u), ref["dxdot"]),
            "step": (plant.step(x, u, DT), ref[itype][0]),
            "A": (A, ref[itype][1]), "B": (Bm, ref[itype][2])}
    A_l, B_l = lanes_plant.step_gradient(x, u, DT)
    lanes_outs = {"xdot": lanes_plant.xdot(x, u),
                  "dxdot": lanes_plant.dxdot(x, u),
                  "step": lanes_plant.step(x, u, DT), "A": A_l, "B": B_l}
    for name, (out, r) in outs.items():
        r = r.reshape(out.shape)
        assert _rel(out, r) < 1e-12, (name, _rel(out, r))
        assert _rel(lanes_outs[name], out.numpy()) < 1e-12, name


def test_options_and_sizes(ytree):
    """``options`` (path_to_urdf, gravity) take precedence; get_num_*; the
    kernel flags are not read without lanes."""
    path, _ = ytree
    plant = TP.URDFPlant(options={"path_to_urdf": path, "gravity": -3.0},
                         use_lanes=False, use_kernel_fd=False,
                         use_kernel_fd_grad=False, use_kernel_task=False)
    assert (plant.get_num_pos(), plant.get_num_vel(), plant.get_num_cntrl()) \
        == (4, 4, 4)
    assert plant.nx == 8 and plant.rbd is not None
    rng = np.random.default_rng(22)
    x_np, u_np = rng.standard_normal((5, 8)), rng.standard_normal((5, 4))
    x, u = t(x_np), t(u_np)
    assert torch.equal(plant.xdot(x, u)[:, 4:],
                       plant.rbd.fd(x[:, :4], x[:, 4:], u, -3.0))
    default = TP.URDFPlant(path, use_lanes=False)
    assert float((default.xdot(x, u) - plant.xdot(x, u)).abs().max()) > 1e-3
    jplant = JP.URDFPlant(options={"path_to_urdf": path, "gravity": -3.0},
                          use_lanes=False)
    jx = np.asarray(jax.jit(jax.vmap(jplant.xdot))(jnp.asarray(x_np),
                                                  jnp.asarray(u_np)))
    assert _rel(plant.xdot(x, u), jx) < 1e-12
    # the lanes plant carries rbd too, as the JAX plant does
    assert TP.URDFPlant(path).rbd is not None


Q = np.diag([1.0, 2.0, 3.0, 0.4])
QF = 10.0 * np.eye(4)
R = np.array([[0.1, 0.02], [0.02, 0.2]])
XG = np.array([0.5, 1.5, 0.1, -0.2])


@pytest.mark.parametrize("mode", range(4))
def test_urdf_cost_on_the_per_sample_plant(mode):
    """UrdfCost on the per-sample plant (tests/test_costs.py:35) against
    the JAX cost on its per-sample plant: values, gradients, Hessians."""
    jrobot = jax_urdf.serial_arm(2)
    jc = JCost.UrdfCost(JP.URDFPlant(robot=jrobot, use_lanes=False),
                        Q, QF, R, XG, QF_start=3, hess_mode=mode)
    tc = TCost.UrdfCost(TP.URDFPlant(robot=convert.robot_from_numpy(jrobot),
                                     use_lanes=False),
                        *map(t, (Q, QF, R, XG)), QF_start=3, hess_mode=mode)
    rng = np.random.default_rng(11)
    x, u, ks = rng.standard_normal((6, 4)), rng.standard_normal((6, 2)), np.arange(6)
    jpar = jc.default_params
    tpar = convert.cost_params_from_numpy(*jpar, device="cpu")
    v = lambda f, *a: jax.vmap(f, in_axes=(None,) + (0,) * len(a))(jpar, *a)
    tx, tu, tk = t(x), t(u), torch.tensor(ks)
    g, H = tc.stage_derivatives(tpar, tx, tu, tk)
    gN, HN = tc.term_derivatives(tpar, tx, tk)
    pairs = {
        "stage_value": (tc.stage_value(tpar, tx, tu, tk), v(jc.stage_value, x, u, ks)),
        "term_value": (tc.term_value(tpar, tx, tk), v(jc.term_value, x, ks)),
        "stage g": (g, v(jc.stage_gradient, x, u, ks)),
        "stage H": (H, v(jc.stage_hessian, x, u, ks)),
        "term g": (gN, v(jc.term_gradient, x, ks)),
        "term H": (HN, v(jc.term_hessian, x, ks)),
    }
    for name, (out, ref) in pairs.items():
        assert _rel(out, ref) < 1e-10, (mode, name, _rel(out, ref))
    if mode == 1:
        # the exact Hessian is the autodiff Hessian of the value
        hv = torch.func.vmap(torch.func.hessian(
            lambda xx, uu, kk: tc.stage_value(tpar, xx[None], uu[None],
                                              kk[None])[0]))(tx, tu, tk)
        np.testing.assert_allclose(H[:, :4, :4], hv, atol=1e-9)


def test_arm2_S_golden_on_the_per_sample_plant():
    """The reference's arm2 method-S run (tests/test_sqp_parity.py:70-83)
    reproduced on the per-sample plant."""
    gold = np.load(GOLDEN / "arm2_S.npz")
    plant = TP.URDFPlant(robot=serial_arm(2), use_lanes=False)
    cost = TCost.UrdfCost(plant, torch.diag(t([1.0, 1.0, 1.0, 1.0])),
                          torch.diag(t([100.0] * 4)), 0.1 * torch.eye(2, dtype=f64),
                          t([0.5, 1.5, 0.0, 0.0]), ref_compat=True)
    solver = make_sqp(plant, cost, None, 10, 0.1, method="S",
                      options=SQPOptions(expected_reduction_min=-100.0))
    res = solver.solve(torch.zeros((1, 4, 10), dtype=f64),
                       torch.zeros((1, 2, 9), dtype=f64))
    assert int(res.exit_sqp[0]) == int(gold["exit_sqp"])
    assert int(res.exit_soft[0]) == int(gold["exit_soft"])
    assert np.abs(res.U[0].numpy() - gold["u"]).max() < 1e-9
    assert np.abs(res.X[0].numpy() - gold["x"]).max() < 1e-9


def _episode(use_lanes):
    """The flagship loop (B = 4, N = 16, 10 steps, f64, CPU)."""
    x0s, goals = F.bench_scenarios(4)
    return F.run_episode(t(x0s), t(goals), steps=10, cold_steps=1, N=16,
                         device="cpu", use_lanes=use_lanes)[1]


def _moved(rel, seed):
    """out -> out (1 + s rel), s = +-1 per element from a fixed seed."""
    gen = torch.Generator().manual_seed(seed)

    def scale(out):
        s = torch.randint(0, 2, out.shape, generator=gen).to(out.dtype)
        return out * (1 + (2 * s - 1) * rel)
    return scale


def test_episode_per_sample_matches_lanes(monkeypatch):
    ps, ln = _episode(False), _episode(True)
    with monkeypatch.context() as m:
        fd_grad, move = lanes.LaneDynamics.fd_grad, _moved(2.0 ** -52, 0)
        m.setattr(lanes.LaneDynamics, "fd_grad",
                  lambda self, *a: move(fd_grad(self, *a)))
        ulp = _episode(True)
    with monkeypatch.context() as m:
        make_rbd, move = TP.make_rbd, _moved(1e-8, 1)

        def faulty(robot):
            rbd = make_rbd(robot)
            return dataclasses.replace(
                rbd, fd_grad=lambda *a: move(rbd.fd_grad(*a)))
        m.setattr(TP, "make_rbd", faulty)
        fault = _episode(False)
    assert torch.equal(ps.iters, ln.iters)
    assert torch.equal(ps.exit_codes, ln.exit_codes)
    gap = lambda a, b: float((a.U_applied - b.U_applied).abs().max()
                             / b.U_applied.abs().max())
    cold = float((ps.U_applied[..., 0] - ln.U_applied[..., 0]).abs().max()
                 / ln.U_applied[..., 0].abs().max())
    assert cold < 1e-9, cold
    bar = max(1e-9, 3 * gap(ulp, ln))
    assert gap(ps, ln) < bar, (gap(ps, ln), bar)
    assert float((ps.X_applied - ln.X_applied).abs().max()
                 / ln.X_applied.abs().max()) < bar
    assert gap(fault, ln) > bar, (gap(fault, ln), bar)
