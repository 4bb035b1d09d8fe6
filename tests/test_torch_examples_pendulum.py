"""The port's pendulum example against the JAX package's, on the CPU in
f64: its single solves (soft AL and hard ACTIVE_SET torque limits) and
its closed loops (iLQR and QP-S) at 5 steps (the script's 40).

The JAX side is tests/golden/examples_jax.npz; each case runs as one
batch of three scenarios (the goal, and the goal moved by +-1 ulp) and is
held under max(1e-8, 3 x its one-ulp gap), counts equal where the moved
runs leave them unchanged (tests/test_torch_examples.py says why).  A
file of its own: the iLQR loop alone takes ~40 s on one CPU thread.
"""

import torch

from test_torch_examples import (  # noqa: F401  (the fixtures)
    BAR,
    CPU,
    MPC_COUNTS,
    SQP_COUNTS,
    golden,
    hold,
    moved_goals,
    one_thread,
    spread_solve,
)
from trajoptmpcreference_tpu_torch.examples import pendulum
from trajoptmpcreference_tpu_torch.solvers.mpc import make_mpc
from trajoptmpcreference_tpu_torch.solvers.sqp import make_sqp


def test_pendulum_single_solves_match_jax(golden, capsys):  # noqa: F811
    """The soft-limit solves by N, S and PCG-SS and the hard-limit solves
    by S and PCG-SS; the exact ones at 1e-8."""
    c = pendulum.config(**CPU)
    for block, methods, opts in (("soft", ("N", "S", "PCG-SS"), None),
                                 ("hard", ("S", "PCG-SS"), c["hard_opts"])):
        for method in methods:
            solver = make_sqp(c["plant"], c["cost"], c[block], pendulum.N,
                              pendulum.dt, method=method, options=opts)
            res = spread_solve(solver, c["cost"], 2, 1, pendulum.N)
            gaps = hold(res, golden, f"pendulum/{block}_{method}",
                        ("X", "U", "J"), SQP_COUNTS)
            if method in ("N", "S") or block == "hard":
                assert all(bar == BAR for _, bar in gaps.values()), gaps


def test_pendulum_mpc_matches_jax(golden, capsys):  # noqa: F811
    """The closed loops by iLQR and QP-S under the soft limits, 5 steps,
    from rest; the example's run prints its three blocks."""
    c = pendulum.config(**CPU)
    goals = moved_goals(c["cost"].default_params.xg)
    for method in ("iLQR", "QP-S"):
        ctrl = make_mpc(c["plant"], c["cost"], c["soft"], pendulum.N,
                        pendulum.dt, method=method)
        res = ctrl.run(torch.zeros((3, 2), dtype=torch.float64), steps=5,
                       cost_params=c["cost"].default_params._replace(
                           xg=goals))
        hold(res, golden, f"pendulum/mpc_{method}", ("X_applied",
                                                     "U_applied"), MPC_COUNTS)
