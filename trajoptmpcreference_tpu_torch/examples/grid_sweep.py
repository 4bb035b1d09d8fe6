"""Config-grid experiment driver — the reference's test_settings.csv grid
(ref: examples/test_multiple.py:31-131, test_settings.csv:1) re-imagined:
each grid row (cost type x Hessian mode x integrator x linear method x
horizon x constraint mode) builds one solver, and the goal sweep within a
row runs as ONE batched solve instead of a multiprocessing.Pool of Python
processes.

Outputs a CSV (one row per config x goal) and a per-config summary table
(markdown to stdout) — feed the CSV to analysis/plot_sweep.py for the
goal-disc heatmaps (the reference's plot_multiple.py analogue).
"""

import csv
import itertools
import time

import numpy as np
import torch

from trajoptmpcreference_tpu_torch import (
    ConstraintSet,
    QuadraticCost,
    SQPOptions,
    URDFPlant,
    UrdfCost,
    make_sqp,
    serial_arm,
)
from trajoptmpcreference_tpu_torch.examples import helpers
from trajoptmpcreference_tpu_torch.examples.batch_sweep import task_dim

INTEGRATORS = {0: "euler", 1: "semi-implicit", 2: "midpoint", 3: "rk3",
               4: "rk4"}
HESS_NAMES = {0: "approx-GN", 1: "exact", 2: "gradTgrad", 3: "none"}


def build_cost(kind, plant, n, hess_mode, device, dtype):
    """Cost per the reference grid's 'type of Cost' column
    (ref: test_multiple.py:85-103): URDF task-space (4 Hessian modes) or
    Quadratic state-space.  (The reference's 'Symbolic' ArmCost is the
    2-link sympy twin of UrdfCost — solvers.costs.ArmCost — equal to URDF
    hess_mode 0 here, so the grid folds it in.)  The task goal has the
    task residual's size, batch_sweep.task_dim."""
    eye = lambda d: torch.eye(d, dtype=dtype, device=device)
    nu = plant.nu
    if kind == "URDF":
        d = task_dim(n)
        xg = torch.zeros(d, dtype=dtype, device=device)
        return UrdfCost(plant, eye(d), 100.0 * eye(d), 0.1 * eye(nu), xg,
                        hess_mode=hess_mode), True
    assert kind == "Quadratic"
    nx = plant.nx
    xg = torch.zeros(nx, dtype=dtype, device=device)
    return QuadraticCost(eye(nx), 100.0 * eye(nx), 0.1 * eye(nu), xg), False


def goal_params(cost, task_space, goals_xy, plant, n, device, dtype):
    """Per-goal cost params: task-space goals go in the EE slot; for the
    quadratic cost the goal is the 2-link IK-free surrogate [x, y] mapped
    onto the first two joint angles (matches the reference's state-space
    rows, which sweep xg directly)."""
    B = goals_xy.shape[0]
    g = np.zeros((B, task_dim(n) if task_space else plant.nx))
    g[:, :2] = goals_xy
    return cost.default_params._replace(xg=helpers.tensors(device, dtype)(g))


def run_config(cfg, goals_xy, args, device="cuda", dtype=torch.float64):
    """One grid row: (result, per-goal error, first-call s, timed-call s)."""
    (kind, hess, integ, method, N, cmode) = cfg
    n = args.links
    plant = URDFPlant(robot=serial_arm(n), integrator_type=integ)
    cost, task_space = build_cost(kind, plant, n, hess, device, dtype)
    cset = None
    if cmode != "none":
        cset = ConstraintSet(plant.nq, plant.nv, plant.nu, N)
        cset = cset.with_torque_limits(
            args.torque_limit, -args.torque_limit, cmode)
    opts = SQPOptions(expected_reduction_min=-100.0, max_iter=args.max_iter,
                      exit_tolerance_linSys=1e-8, max_iter_linSys=100)
    solver = make_sqp(plant, cost, cset, N, args.dt, method=method,
                      options=opts)
    cps = goal_params(cost, task_space, goals_xy, plant, n, device, dtype)
    B = goals_xy.shape[0]
    x0s = torch.zeros((B, plant.nx, N), dtype=dtype, device=device)
    u0s = torch.zeros((B, plant.nu, N - 1), dtype=dtype, device=device)
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else lambda: None)
    t0 = time.perf_counter()
    res = solver.solve(x0s, u0s, cost_params=cps)
    sync()
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = solver.solve(x0s, u0s, cost_params=cps)
    sync()
    t_run = time.perf_counter() - t0

    xf = res.X[:, :, -1]
    if task_space:
        ee = plant.kinematics.ee_pos_x(xf).double().cpu().numpy()
        err = np.linalg.norm(ee - goals_xy, axis=1)
    else:
        err = np.linalg.norm(xf[:, :2].double().cpu().numpy() - goals_xy,
                             axis=1)
    return res, err, t_first, t_run


def goal_grid(n, n_goals):
    """(n_goals, 2) goals of a square grid filtered to the reachable disc
    (ref: test_multiple.py:25-29), the last repeated to fill the batch."""
    side = int(np.ceil(np.sqrt(2 * n_goals)))
    while True:
        # a too-coarse square grid can put every point outside the disc
        # (e.g. --n-goals 2): densify until at least one point lands inside
        xs = np.linspace(-0.9 * n, 0.9 * n, side)
        pts = np.array([[x, y] for x in xs for y in xs
                        if x * x + y * y <= (0.9 * n) ** 2])
        if pts.size:
            break
        side *= 2
    goals_xy = pts[:n_goals]
    while goals_xy.shape[0] < n_goals:
        goals_xy = np.vstack([goals_xy, goals_xy[-1:]])
    return goals_xy


def grid(args):
    """The grid rows (cost, hess, integrator, method, N, constraints)."""
    rows = []
    for kind in args.costs:
        hmodes = args.hess if kind == "URDF" else [0]
        for hess, integ, method, N, cmode in itertools.product(
                hmodes, args.integrators, args.methods, args.N,
                args.constraints):
            rows.append((kind, hess, integ, method, N, cmode))
    return rows


def table_row(cfg, res, err, t_c, t_r):
    """The summary table's line for one grid row."""
    kind, hess, integ, method, N, cmode = cfg
    exits = res.exit_sqp.cpu().numpy()
    iters = res.sqp_iters.cpu().numpy()
    conv = int((exits == 1).sum())
    return (f"| {kind} | {HESS_NAMES[hess] if kind == 'URDF' else '-'} "
            f"| {INTEGRATORS[integ]} | {method} | {N} | {cmode} "
            f"| {conv}/{len(err)} | {np.median(err):.4f} "
            f"| {np.max(err):.3f} | {iters.mean():.1f} | {t_c:.1f} "
            f"| {t_r:.2f} |")


def parser():
    ap = helpers.parser(__doc__)
    ap.add_argument("--links", type=int, default=2)
    ap.add_argument("--n-goals", type=int, default=16)
    ap.add_argument("--dt", type=float, default=0.1)
    ap.add_argument("--max-iter", type=int, default=20)
    ap.add_argument("--torque-limit", type=float, default=7.0,
                    help="the reference drivers' +/-7 (ref: pendulum.py:17)")
    ap.add_argument("--costs", nargs="+", default=["URDF", "Quadratic"])
    ap.add_argument("--hess", nargs="+", type=int, default=[0, 2],
                    help="UrdfCost Hessian modes (ref: TrajoptCost.py:391)")
    ap.add_argument("--integrators", nargs="+", type=int, default=[0, 1])
    ap.add_argument("--methods", nargs="+", default=["S", "PCG-SS"])
    ap.add_argument("--N", nargs="+", type=int, default=[10])
    ap.add_argument("--constraints", nargs="+", default=["none"],
                    choices=["none", "AUGMENTED_LAGRANGIAN", "ACTIVE_SET",
                             "QUADRATIC_PENALTY", "FULL_SET"])
    ap.add_argument("--out", default=None, help="per-goal results CSV")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    setting = helpers.setting(args)
    goals_xy = goal_grid(args.links, args.n_goals)
    print("| cost | hess | integrator | method | N | constraints "
          "| conv | med err [m] | max err | mean iters | first call [s] "
          "| run [s] |")
    print("|---|---|---|---|---|---|---|---|---|---|---|---|")
    rows = []
    for cfg in grid(args):
        kind, hess, integ, method, N, cmode = cfg
        res, err, t_c, t_r = run_config(cfg, goals_xy, args, **setting)
        print(table_row(cfg, res, err, t_c, t_r), flush=True)
        exits = res.exit_sqp.cpu().numpy()
        iters = res.sqp_iters.cpu().numpy()
        for i in range(len(err)):
            rows.append({
                "cost": kind, "hess": hess, "integrator": integ,
                "method": method, "N": N, "constraints": cmode,
                "goal_x": goals_xy[i, 0], "goal_y": goals_xy[i, 1],
                "ee_err": err[i], "exit": int(exits[i]),
                "iters": int(iters[i])})
    if args.out:
        with open(args.out, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)
        print(f"wrote {len(rows)} rows to {args.out}")


if __name__ == "__main__":
    main()
