"""The plain reference against the port's CPU path at a tiny batch, in
float64, where the two agree to rounding: the cold step from the
benchmark's scenarios and steady steps from the port's own state."""

import json
import pathlib

import pytest
import torch

from benchlib import traffic
from reference.arm import PlanarArm
from reference.sqp import Problem, mpc_step

BENCH = pathlib.Path(__file__).resolve().parents[1]


def _cfg(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def test_arm_matches_the_port_plant():
    from trajoptmpcreference_tpu_torch import flagship as F
    plant, _, _ = F.flagship_mpc(dtype=torch.float64, device="cpu")
    cfg = _cfg("arm6_s")
    arm = PlanarArm(cfg["robot"], cfg["dt"], cfg["sim_qd_max"])
    g = torch.Generator().manual_seed(0)
    x = torch.randn(7, 12, generator=g, dtype=torch.float64)
    u = torch.randn(7, 6, generator=g, dtype=torch.float64)
    close = lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=1e-10)
    close(arm.step(x, u), plant.step(x, u, cfg["dt"]))
    A, B = plant.step_gradient(x, u, cfg["dt"])
    A2, B2 = arm.step_jacobians(x, u)
    close(A2, A)
    close(B2, B)
    close(arm.task(x), plant.kinematics.task_vec_x(x))
    close(arm.task_jacobian(x), plant.kinematics.jacobian_tot_state_x(x))
    close(arm.ee_xy(x), plant.kinematics.ee_pos_x(x))


@pytest.mark.parametrize("name", ["arm6_s", "arm6_as", "arm6_pcg"])
def test_reference_steps_match_the_port(name):
    from benchlib.loop import build
    cfg = _cfg(name)
    cfg["dtype"] = "float64"
    _, cost, ctrl, cold = build(cfg, "cpu")
    tr = json.loads((BENCH / "traffic" / "b512.json").read_text())
    tr["batch"] = 3
    x0s, goals = traffic.episode(tr, 5, 0)
    x = torch.tensor(x0s)
    g = torch.tensor(goals)
    params = cost.default_params._replace(xg=g)
    prob = Problem(cfg, torch.float64, "cpu")
    carry = {}
    for k in range(3):
        knobs = cfg["cold_knobs"] if k == 0 else cfg["knobs"]
        res = (cold if k == 0 else ctrl).run(x, 1, cost_params=params, **carry)
        ref = mpc_step(prob, x, g, knobs, carry.get("X_init"),
                       carry.get("U_init"), carry.get("lam_init"))
        gap = lambda a, b: (a - b).abs().max().item()
        assert gap(res.U_plan_last, ref.U_plan) < 1e-4
        assert gap(res.X_plan_last, ref.X_plan) < 1e-4
        assert gap(res.U_applied[..., 0], ref.u0) < 1e-4
        assert gap(res.X_applied[..., -1], ref.x1) < 1e-4
        assert gap(res.lam_last, ref.lam) / ref.lam.abs().max().item() < 1e-5
        assert torch.equal(res.iters[..., 0], ref.iters)
        carry = dict(X_init=res.X_plan_last, U_init=res.U_plan_last,
                     cstate_init=res.cstate_last, lam_init=res.lam_last)
        x = res.X_applied[..., -1]


def test_reference_pcg_stops_at_its_cap_and_starts_from_its_guess():
    """The reference's PCG-SS at ``pcg_iters`` = 3 is still far from the
    exact Schur solution, which it reaches when it runs to convergence;
    started from the exact solution, three iterations keep it."""
    cfg = _cfg("arm6_pcg")
    tr = json.loads((BENCH / "traffic" / "b512.json").read_text())
    tr["batch"] = 2
    x0s, goals = traffic.episode(tr, 7, 0)
    x, g = torch.tensor(x0s), torch.tensor(goals)
    prob = Problem(cfg, torch.float64, "cpu")
    Xk = x[:, None, :].expand(2, prob.N, prob.nx)
    Uk = x.new_zeros(2, prob.N - 1, prob.nu)
    rho = torch.full((2,), 1e-3, dtype=torch.float64)
    zero = x.new_zeros(2, prob.N, prob.nx)

    def lam(knobs, guess=zero):
        return prob.newton_step(Xk, Uk, x, g[:, None, :], rho, knobs,
                                guess)[2]
    exact = lam(dict(cfg["knobs"], method="S"))
    gap = lambda a: ((a - exact).abs().amax() / exact.abs().amax()).item()
    assert gap(lam(dict(cfg["knobs"], pcg_iters=3))) > 0.1
    assert gap(lam(dict(cfg["knobs"], pcg_iters=3000, pcg_tol=1e-24))) < 1e-6
    assert gap(lam(dict(cfg["knobs"], pcg_iters=3), exact)) < 1e-7
