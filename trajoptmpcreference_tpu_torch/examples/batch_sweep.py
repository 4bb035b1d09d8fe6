"""Goal sweep over the reachable disc — the reference's parameterized grid
driver (ref: examples/test_multiple.py + test_settings.csv) re-imagined:
instead of a multiprocessing.Pool over configs, the whole sweep is ONE
batched solve (split over the ranks of a torchrun job with --shard)."""

import numpy as np
import torch

from trajoptmpcreference_tpu_torch import (
    SQPOptions,
    URDFPlant,
    UrdfCost,
    make_sqp,
    serial_arm,
)
from trajoptmpcreference_tpu_torch.examples import helpers
from trajoptmpcreference_tpu_torch.parallel import (
    batch_solve,
    global_mesh,
    initialize,
    shard_solve,
)
from trajoptmpcreference_tpu_torch.utils.timing import time_fn


def task_dim(n):
    """The task residual's size, [ee position; ee velocity] over k =
    min(3, n) dimensions: 2 k.  (The JAX script sizes it k + n, which is
    2 k only up to 3 links: at --links 6 its cost raises a shape error.)"""
    return 2 * min(3, n)


def goals_on_disc(n, n_goals):
    """(n_goals, 2 k) goals on rings of the reachable disc (radius < n
    links), from default_rng(0)."""
    rng = np.random.default_rng(0)
    radii = 0.2 * n + 0.7 * n * rng.random(n_goals)
    angs = 2 * np.pi * rng.random(n_goals)
    goals = np.zeros((n_goals, task_dim(n)))
    goals[:, 0] = radii * np.cos(angs)
    goals[:, 1] = radii * np.sin(angs)
    return goals


def problem(links=2, N=10, method="PCG-SS", device="cuda",
            dtype=torch.float64):
    """(plant, cost, solver) of the sweep: the n-link arm's task-space
    reach by SQP ``method``."""
    plant = URDFPlant(robot=serial_arm(links))
    d = task_dim(links)
    eye = lambda m: torch.eye(m, dtype=dtype, device=device)
    cost = UrdfCost(plant, eye(d), 100.0 * eye(d), 0.1 * eye(plant.nu),
                    torch.zeros(d, dtype=dtype, device=device))
    solver = make_sqp(plant, cost, None, N, 0.1, method=method,
                      options=SQPOptions(expected_reduction_min=-100.0))
    return plant, cost, solver


def sweep(links=2, n_goals=64, N=10, method="PCG-SS", shard=False,
          device="cuda", dtype=torch.float64, verbose=True, warmup=1):
    """One timed batched solve of the sweep after ``warmup`` untimed ones;
    returns dict(goals, res, err (per goal), wall) and prints the JAX
    script's line.  ``shard`` splits the batch over every rank of the job
    (a torchrun launch: parallel.initialize, one card a rank)."""
    plant, cost, solver = problem(links, N, method, device, dtype)
    goals = goals_on_disc(links, n_goals)
    cps = cost.default_params._replace(xg=helpers.tensors(device, dtype)(goals))
    B = n_goals
    x0s = torch.zeros((B, plant.nx, N), dtype=dtype, device=device)
    u0s = torch.zeros((B, plant.nu, N - 1), dtype=dtype, device=device)
    if shard:
        kind = torch.device(device).type
        initialize(device_type=kind)
        fn = shard_solve(solver, global_mesh(("batch",), device_type=kind))
    else:
        fn = batch_solve(solver)
    wall, res = time_fn(fn, x0s, u0s, cps, reps=1, warmup=warmup)
    ee = plant.kinematics.ee_pos_x(res.X[:, :, -1])
    err = np.linalg.norm(ee.double().cpu().numpy() - goals[:, :2], axis=1)
    ok = (res.exit_sqp == 1).cpu().numpy()
    if verbose:
        print(f"{B} goal solves in {wall*1e3:.1f}ms ({B/wall:.1f} solves/s)  "
              f"converged {ok.sum()}/{B}  median EE err {np.median(err):.4f} m")
    return dict(goals=goals, res=res, err=err, wall=wall)


def write_csv(path, out):
    import csv
    res, goals, err = out["res"], out["goals"], out["err"]
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["goal_x", "goal_y", "J", "iters", "exit", "ee_err"])
        for i in range(len(goals)):
            w.writerow([goals[i, 0], goals[i, 1], float(res.J[i]),
                        int(res.sqp_iters[i]), int(res.exit_sqp[i]), err[i]])
    print("wrote", path)


def main(argv=None):
    ap = helpers.parser(__doc__)
    ap.add_argument("--links", type=int, default=2)
    ap.add_argument("--n-goals", type=int, default=64)
    ap.add_argument("--N", type=int, default=10)
    ap.add_argument("--method", default="PCG-SS")
    ap.add_argument("--shard", action="store_true",
                    help="split the sweep over the ranks of a torchrun job")
    ap.add_argument("--out", default=None, help="write results CSV")
    args = ap.parse_args(argv)
    out = sweep(args.links, args.n_goals, args.N, args.method, args.shard,
                **helpers.setting(args))
    if args.out:
        write_csv(args.out, out)


if __name__ == "__main__":
    main()
