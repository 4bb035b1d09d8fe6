"""Animate a planar n-link trajectory (ref: examples/display_final_traj.py).

Reads an .npz recorded by helpers (record=True) or solves twolinks fresh,
then renders per-step frames with matplotlib (gated: prints the joint
angles instead if matplotlib is unavailable)."""

import pathlib

import numpy as np
import torch

from trajoptmpcreference_tpu_torch.examples import helpers


def link_points(q, link_length=1.0):
    """Joint positions of a planar z-revolute serial chain (links along the
    rotated +y axis, matching the URDF geometry)."""
    pts = [np.zeros(2)]
    th = 0.0
    for qi in np.asarray(q):
        th += qi
        # z-rotation of the +y unit vector
        step = link_length * np.array([-np.sin(th), np.cos(th)])
        pts.append(pts[-1] + step)
    return np.stack(pts)


def solve_twolinks(goal, device="cuda", dtype=torch.float64):
    """The 2-link reach to ``goal`` by method S: X (4, 10) as numpy."""
    from trajoptmpcreference_tpu_torch import (
        SQPOptions, URDFPlant, UrdfCost, make_sqp, serial_arm)
    t = helpers.tensors(device, dtype)
    eye = lambda d: torch.eye(d, dtype=dtype, device=device)
    plant = URDFPlant(robot=serial_arm(2))
    cost = UrdfCost(plant, eye(4), 100 * eye(4), 0.1 * eye(2),
                    t([goal[0], goal[1], 0.0, 0.0]))
    solver = make_sqp(plant, cost, None, 10, 0.1, method="S",
                      options=SQPOptions(expected_reduction_min=-100.0))
    res = solver.solve(torch.zeros((1, 4, 10), dtype=dtype, device=device),
                       torch.zeros((1, 2, 9), dtype=dtype, device=device))
    return res.X[0].cpu().numpy()


def render(X, goal, out):
    """Frames of X (2n, T) into ``out``, or the joint angles printed where
    matplotlib is missing; returns the frame paths (none when printed)."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib not available; printing joint angles instead")
        for k in range(X.shape[1]):
            print(f"step {k}: q = {X[:X.shape[0] // 2, k].round(4)}")
        return []
    out = pathlib.Path(out)
    out.mkdir(exist_ok=True)
    n = X.shape[0] // 2
    frames = []
    for k in range(X.shape[1]):
        pts = link_points(X[:n, k])
        fig, ax = plt.subplots(figsize=(4, 4))
        ax.plot(pts[:, 0], pts[:, 1], "o-", lw=3)
        ax.plot(*goal, "r*", ms=15)
        lim = n + 0.5
        ax.set_xlim(-lim, lim)
        ax.set_ylim(-lim, lim)
        ax.set_aspect("equal")
        ax.set_title(f"step {k}")
        frames.append(out / f"frame_{k:03d}.png")
        fig.savefig(frames[-1], dpi=80)
        plt.close(fig)
    print(f"wrote {X.shape[1]} frames to {out}/")
    return frames


def main(argv=None):
    ap = helpers.parser(__doc__)
    ap.add_argument("--npz", default=None, help="recorded trajectory .npz")
    ap.add_argument("--out", default="traj_frames", help="output directory")
    ap.add_argument("--goal", type=float, nargs=2, default=[0.5, 1.5])
    args = ap.parse_args(argv)
    if args.npz:
        X = np.load(args.npz)["x"]
    else:
        X = solve_twolinks(args.goal, **helpers.setting(args))
    return render(X, args.goal, args.out)


if __name__ == "__main__":
    main()
