"""The port's examples (trajoptmpcreference_tpu_torch.examples) against
the JAX package's, on the CPU in f64, at reduced sizes.

The JAX side of each solve is read from tests/golden/examples_jax.npz,
written by ``python tests/examples_reference.py --golden ...``: the JAX
package's objects built with each example script's own constants, run at
the sizes below (a JAX solve compiles in 15-25 s on the CPU, so the tests
read the results instead of compiling a dozen solvers).  compare_cost's
three gradients are held to the JAX package's costs live (no compile).

Bars.  Several examples sit on decision edges that rounding sets: a one-ulp
move of the goal changes twolinks' PCG-J SQP iterations (3 or 4) and X by
4%, the pendulum's soft PCG-SS solve from 8 to 3 iterations, and QP-S's
first MPC step from 15 to 22 or 3.  So each case runs as one batch of
three scenarios: its goal, and the goal moved by +1 and by -1 ulp; the
first is held to JAX under max(1e-8, 3 x the larger gap to the moved
two), each field relative to its scale, and its exit codes and iteration
counts are held equal to JAX's wherever the moved two leave them
unchanged (elsewhere they sit on an edge).  The exact solves (methods N
and S, the hard-limit solves) meet 1e-8 this way, their one-ulp gaps
~1e-13.  (mpc_arm6 moves its dynamics' outputs instead: see its test.)
Sizes: mpc_arm6 N = 16 and 3 steps (64 and 100), batch_sweep 8
goals (64), one grid_sweep row (URDF, gradTgrad Hessian, Euler, PCG-SS,
N = 10) at 4 goals; the pendulum is tests/test_torch_examples_pendulum.py.
One intra-op thread: the tensors are small, and under several test
workers torch's thread pool only contends with the other workers'.
"""

import contextlib
import pathlib
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajoptmpcreference_tpu import ArmCost as JArmCost
from trajoptmpcreference_tpu import NumericalCost as JNumericalCost
from trajoptmpcreference_tpu import URDFPlant as JURDFPlant
from trajoptmpcreference_tpu import UrdfCost as JUrdfCost
from trajoptmpcreference_tpu import serial_arm as jserial_arm
from trajoptmpcreference_tpu_torch.examples import (
    batch_sweep,
    compare_cost,
    display_final_traj,
    grid_sweep,
    helpers,
    mpc_arm6,
    quadratic,
    twolinks,
)
from trajoptmpcreference_tpu_torch.ops.kinematics import LaneKinematics
from trajoptmpcreference_tpu_torch.ops.lanes import LaneDynamics
from trajoptmpcreference_tpu_torch.solvers.sqp import make_sqp

GOLDEN = pathlib.Path(__file__).parent / "golden" / "examples_jax.npz"
CPU = dict(device="cpu", dtype=torch.float64)
BAR = 1e-8
EPS = 2.0 ** -52
SQP_COUNTS = ("exit_sqp", "sqp_iters")
MPC_COUNTS = ("exit_codes", "iters")
GOLDEN_NAME = {"sqp_iters": "iters", "X_applied": "X", "U_applied": "U"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as g:
        return {k: g[k] for k in g.files}


def moved_goals(xg):
    """(3 B, d) goals from (B, d) or (d,): the goals, the goals moved by
    +1 ulp, by -1 ulp."""
    xg = xg.reshape(-1, xg.shape[-1])
    return torch.cat([xg, xg * (1 + EPS), xg * (1 - EPS)])


def hold(res, golden, key, fields, counts):
    """Hold the first third of each batched result field (the example's
    own scenarios) to JAX's under max(BAR, 3 x its one-ulp gap: the
    largest gap to the other two thirds, the goals moved by +-1 ulp),
    relative to the JAX field's scale; each count field equal to JAX's
    where the moved runs leave it unchanged.  Returns {field: (gap, bar)}."""
    out = {}
    for field in fields + counts:
        t = getattr(res, field).detach().cpu()
        B = t.shape[0] // 3
        base, up, dn = t[:B], t[B:2 * B], t[2 * B:]
        ref = torch.as_tensor(golden[f"{key}/{GOLDEN_NAME.get(field, field)}"])
        ref = ref.reshape(base.shape)
        if field in counts:
            stable = (base == up) & (base == dn)
            assert torch.equal(base[stable], ref[stable].to(base.dtype)), (
                key, field, base, ref)
            continue
        scale = float(ref.abs().max())
        ulp = float(torch.maximum((up - base).abs().max(),
                                  (dn - base).abs().max())) / scale
        gap = float((base - ref).abs().max()) / scale
        bar = max(BAR, 3 * ulp)
        assert gap < bar, (key, field, gap, bar)
        out[field] = (gap, bar)
    return out


def spread_solve(solver, cost, nx, nu, N, xg=None):
    """One batched SQP solve from zero of the goals ``xg`` (the cost's
    own by default) and their one-ulp moves."""
    goals = moved_goals(cost.default_params.xg if xg is None else xg)
    B = goals.shape[0]
    zeros = lambda *s: torch.zeros(s, dtype=goals.dtype)
    return solver.solve(zeros(B, nx, N), zeros(B, nu, N - 1),
                        cost_params=cost.default_params._replace(xg=goals))


def test_twolinks_matches_jax(golden, tmp_path):
    """Every SQP method of twolinks; the runner's record of one."""
    plant, cost, cset, options = twolinks.config(**CPU)
    for method in twolinks.METHODS:
        solver = make_sqp(plant, cost, cset, twolinks.N, twolinks.dt,
                          method=method, options=options)
        res = spread_solve(solver, cost, 4, 2, twolinks.N)
        gaps = hold(res, golden, f"twolinks/{method}", ("X", "U", "J"),
                    SQP_COUNTS)
        if method in ("N", "S"):
            assert all(bar == BAR for _, bar in gaps.values()), gaps
    out = twolinks.run(**CPU, methods=["S"], verbose=False, record=True,
                       out_dir=tmp_path, warmup=0)
    res, wall = out["S"]
    rec = np.load(tmp_path / "0" / "sqp_S.npz")
    np.testing.assert_array_equal(rec["x"], res.X[0].numpy())
    assert int(rec["iters"]) == int(res.sqp_iters[0]) and wall > 0
    assert float(np.abs(rec["x"] - golden["twolinks/S/X"]).max()) < BAR


def test_quadratic_matches_jax(golden):
    """Methods N and S on the joint-space cost with hard torque limits:
    exact solves, held at 1e-8."""
    plant, cost, cset = quadratic.config(**CPU)
    for method in quadratic.METHODS:
        solver = make_sqp(plant, cost, cset, quadratic.N, quadratic.dt,
                          method=method)
        gaps = hold(spread_solve(solver, cost, 4, 2, quadratic.N), golden,
                    f"quadratic/{method}", ("X", "U", "J"), SQP_COUNTS)
        assert all(bar == BAR for _, bar in gaps.values()), gaps


@contextlib.contextmanager
def dynamics_moved_one_ulp(seed):
    """While in the block, the lanes dynamics (fd, fd_grad) and the task
    residual return their outputs times 1 +- eps per element, from
    ``seed``: the rounding of every evaluation moved by one ulp (as
    chip_smoke.py's phase 5 moves the plain outputs)."""
    gen = torch.Generator().manual_seed(seed)
    targets = [(LaneDynamics, "fd"), (LaneDynamics, "fd_grad"),
               (LaneKinematics, "task_vec")]
    saved = [(cls, name, getattr(cls, name)) for cls, name in targets]

    def moved(fn):
        def call(self, *args):
            out = fn(self, *args)
            s = torch.randint(0, 2, out.shape, generator=gen)
            return out * (1 + (2 * s - 1).to(out.dtype) * EPS)
        return call

    for cls, name, fn in saved:
        setattr(cls, name, moved(fn))
    try:
        yield
    finally:
        for cls, name, fn in saved:
            setattr(cls, name, fn)


@pytest.mark.parametrize("limit", [0.0, 6.0])
def test_mpc_arm6_matches_jax(limit, golden, capsys):
    """mpc_arm6 at N = 16 and 3 steps, as shipped and with --torque-limit
    6 (hard ACTIVE_SET rows, the condensed path), by the example's run
    (which prints the JAX script's lines): the closed loop, the final
    end-effector error and max |u|.  A one-ulp move of the goal moves this
    loop by ~5e-9 of its scale, under its gap to JAX (~2e-7: the PCG's
    relative exit at 1e-4 carries rounding into every step), so the
    one-ulp gap here moves the dynamics' outputs instead: two runs with
    fd, fd_grad and the task residual moved by +-1 ulp, the bar 3 x the
    larger gap."""
    key = f"mpc_arm6/limit{limit:g}"
    run = lambda: mpc_arm6.run(N=16, steps=3, torque_limit=limit, **CPU,
                               warmup=0)
    outs = [run()]
    text = capsys.readouterr().out
    for seed in (0, 1):
        with dynamics_moved_one_ulp(seed):
            outs.append(run())
    stack = lambda f: types.SimpleNamespace(**{
        name: torch.cat([getattr(o["res"], name) for o in outs])
        for name in (f + MPC_COUNTS)})
    hold(stack(("X_applied", "U_applied")), golden, key,
         ("X_applied", "U_applied"), MPC_COUNTS)
    for field in ("ee_err", "max_abs_u"):
        ref = float(golden[f"{key}/{field}"])
        ulp = max(abs(o[field] - outs[0][field]) for o in outs[1:])
        assert abs(outs[0][field] - ref) < max(BAR * abs(ref), 3 * ulp), field
    assert "3 MPC steps in" in text
    assert f"err {outs[0]['ee_err']:.4f} m" in text
    assert ("max |u| applied" in text) == (limit > 0)


def test_batch_sweep_matches_jax(golden, tmp_path, capsys):
    """batch_sweep at 8 goals (2 links, N = 10, PCG-SS): the goals, every
    scenario's solve, the printed line and the CSV."""
    goals = batch_sweep.goals_on_disc(2, 8)
    np.testing.assert_array_equal(goals, golden["batch_sweep/sweep/goals"])
    plant, cost, solver = batch_sweep.problem(**CPU)
    res = spread_solve(solver, cost, 4, 2, 10, xg=torch.tensor(goals))
    hold(res, golden, "batch_sweep/sweep", ("X", "U", "J"), SQP_COUNTS)
    out = batch_sweep.sweep(n_goals=8, **CPU, warmup=0)
    assert "8 goal solves in" in capsys.readouterr().out
    batch_sweep.write_csv(tmp_path / "sweep.csv", out)
    rows = (tmp_path / "sweep.csv").read_text().splitlines()
    assert len(rows) == 9 and rows[0].startswith("goal_x,goal_y,J")


def test_sweep_goals_fit_six_links():
    """The sweeps' task goal has the task residual's size, 2 min(3, n):
    the JAX scripts' min(3, n) + n up to 3 links, where JAX's breaks at 6
    (its cost subtracts a 9-vector goal from a 6-vector residual)."""
    assert [batch_sweep.task_dim(n) for n in (1, 2, 3)] == [2, 4, 6]
    assert batch_sweep.task_dim(6) == 6
    plant, cost, solver = batch_sweep.problem(links=6, N=3, method="S", **CPU)
    p = cost.default_params._replace(
        xg=torch.tensor(batch_sweep.goals_on_disc(6, 2)))
    x = 0.1 * torch.ones((2, 12), dtype=torch.float64)
    u, k = torch.zeros((2, 6), dtype=torch.float64), torch.tensor([0, 1])
    assert cost.stage_value(p, x, u, k).shape == (2,)
    assert cost.stage_gradient(p, x, u, k).shape == (2, 18)


def test_grid_sweep_row_matches_jax(golden):
    """One grid row: its goals, its batched solve as run_config builds
    it, and its line of the summary table."""
    args = grid_sweep.parser().parse_args(["--device", "cpu"])
    goals_xy = grid_sweep.goal_grid(args.links, 4)
    np.testing.assert_array_equal(goals_xy, golden["grid_sweep/row/goals"])
    cfg = ("URDF", 2, 0, "PCG-SS", 10, "none")
    assert cfg in grid_sweep.grid(args)
    moved = np.concatenate([goals_xy, goals_xy * (1 + EPS),
                            goals_xy * (1 - EPS)])
    res, err, _, _ = grid_sweep.run_config(cfg, moved, args, **CPU)
    hold(res, golden, "grid_sweep/row", ("X", "U", "J"), SQP_COUNTS)
    assert np.isfinite(err).all()
    assert grid_sweep.table_row(cfg, res, err, 1.0, 0.5).startswith(
        "| URDF | gradTgrad | euler | PCG-SS | 10 | none | ")


def test_compare_cost_matches_jax():
    """The three 2-link costs' stage values and gradients at the script's
    point, against the JAX package's (1e-10: the same functions; the
    numerical cost's central difference agrees to its rounding)."""
    out = compare_cost.run(**CPU, verbose=False)
    plant = JURDFPlant(robot=jserial_arm(2))
    a = (jnp.eye(4), 100.0 * jnp.eye(4), 0.1 * jnp.eye(2),
         jnp.array([0.5, 1.5, 0.0, 0.0]))
    costs = {"urdf": JUrdfCost(plant, *a), "arm": JArmCost(*a),
             "numerical": JNumericalCost(plant, *a)}
    x, u = jnp.array(compare_cost.X), jnp.array(compare_cost.U)
    k = jnp.asarray(compare_cost.K)
    for name, c in costs.items():
        v, g = out[name]
        jv = float(c.stage_value(c.default_params, x, u, k))
        jg = np.asarray(c.stage_gradient(c.default_params, x, u, k))
        assert abs(v - jv) <= 1e-10 * abs(jv), name
        assert float(np.abs(g - jg).max() / np.abs(jg).max()) < 1e-10, name
    assert np.abs(out["urdf"][1] - out["arm"][1]).max() < 1e-12


@pytest.mark.parametrize("plotting", [True, False])
def test_display_final_traj_from_npz(plotting, golden, tmp_path, monkeypatch,
                                     capsys):
    """display_final_traj from a recorded .npz: one frame a knot with
    matplotlib, the joint angles printed without it."""
    X = golden["twolinks/S/X"]
    np.savez(tmp_path / "sqp_S.npz", x=X)
    if not plotting:
        monkeypatch.setitem(sys.modules, "matplotlib", None)
    frames = display_final_traj.main(["--npz", str(tmp_path / "sqp_S.npz"),
                                      "--out", str(tmp_path / "frames"),
                                      "--device", "cpu"])
    text = capsys.readouterr().out
    if plotting:
        assert len(frames) == X.shape[1] and all(f.exists() for f in frames)
    else:
        assert frames == []
        assert text.count("step ") == X.shape[1]
    pts = display_final_traj.link_points(X[:2, -1])
    assert pts.shape == (3, 2)
    assert np.allclose(np.linalg.norm(np.diff(pts, axis=0), axis=1), 1.0)


def test_examples_import_no_jax(tmp_path):
    """Every example imports with jax unimportable (a fresh process) and
    display_final_traj runs there; --device defaults to the card (raising
    here without CUDA) and --dtype to float64."""
    np.savez(tmp_path / "x.npz", x=np.zeros((4, 3)))
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "sys.modules['matplotlib'] = None\n"
        "from trajoptmpcreference_tpu_torch.examples import "
        + ", ".join(["batch_sweep", "compare_cost", "display_final_traj",
                     "grid_sweep", "helpers", "mpc_arm6", "pendulum",
                     "quadratic", "threelinks", "twolinks"]) + "\n"
        f"display_final_traj.main(['--npz', r'{tmp_path / 'x.npz'}', "
        "'--device', 'cpu'])\n")
    root = pathlib.Path(__file__).resolve().parents[1]
    done = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr
    assert done.stdout.count("step ") == 3
    args = helpers.parser(__doc__).parse_args([])
    assert (args.device, args.dtype) == ("cuda", "float64")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            helpers.setting(args)
    cpu = helpers.setting(types.SimpleNamespace(device="cpu", dtype="float32"))
    assert cpu == dict(device=torch.device("cpu"), dtype=torch.float32)
