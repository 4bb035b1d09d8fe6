"""The JAX package's examples, run on the CPU in f64, their numbers kept.

Two uses:

* ``--golden PATH`` writes the results of each example (examples/*.py),
  built from the JAX package with the scripts' own constants and run at
  tests/test_torch_examples.py's reduced sizes, to one .npz (keys
  ``<example>/<case>/<field>``): the oracle that test holds the port's
  examples to.  A JAX solve compiles in 15-25 s on the CPU, so the test
  reads this file instead of compiling a dozen of them;
* with no ``--golden``, mpc_arm6 at its own size (N = 64, 100 steps,
  QP-PCG-SS, with and without a torque limit of 6) prints one JSON line
  per setting with the final end-effector error and max |u| in full: the
  values chip_smoke.py's phase 25 holds the port's f64 run to; with
  ``--moves K``, K more runs without the limit from x0 moved by +-1 ulp
  per element (signs from default_rng(k)), and the first step at which
  each run's state leaves the unmoved run's by 1e-3 and by 0.1: the
  JAX package's own one-ulp spread.

    JAX_PLATFORMS=cpu python tests/examples_reference.py [--golden tests/golden/examples_jax.npz]

It imports the JAX package, never the ``examples/`` scripts (whose
``_path.py`` sets JAX's process-wide platform).
"""

import argparse
import json
import os
import pathlib
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from trajoptmpcreference_tpu import (  # noqa: E402
    ConstraintSet,
    PendulumPlant,
    QuadraticCost,
    SQPOptions,
    URDFPlant,
    UrdfCost,
    make_mpc,
    make_sqp,
    serial_arm,
)
from trajoptmpcreference_tpu.parallel import batch_solve  # noqa: E402

# the reduced sizes tests/test_torch_examples.py runs
PENDULUM_STEPS = 5
ARM6_N, ARM6_STEPS = 16, 3
SWEEP_GOALS = 8
GRID_ROW = ("URDF", 2, 0, "PCG-SS", 10, "none")   # cost, hess, integrator,
GRID_GOALS = 4                                     # method, N, constraints


def mpc_arm6(N=64, steps=100, torque_limit=0.0, dt=0.015, moved=None):
    """examples/mpc_arm6.py's run: (final EE error, max |u| applied,
    the result); ``moved`` (12,) of +-1 moves x0 by one ulp per element."""
    plant = URDFPlant(robot=serial_arm(6))
    cost = UrdfCost(plant, jnp.diag(jnp.asarray([1.0, 1.0, 1.0, 0.1, 0.1, 0.1])),
                    100.0 * jnp.eye(6), 0.01 * jnp.eye(6),
                    jnp.asarray([3.0, 2.0, 0.0, 0.0, 0.0, 0.0]))
    options = SQPOptions(expected_reduction_min=-100.0, exit_tolerance=1e-4,
                         exit_tolerance_linSys=1e-4, max_iter=5,
                         max_iter_linSys=40)
    cset = None
    if torque_limit > 0:
        cset = ConstraintSet(6, 6, 6, N).with_torque_limits(
            torque_limit, -torque_limit, "ACTIVE_SET", activation_band=0.2)
    ctrl = make_mpc(plant, cost, cset, N, dt, method="QP-PCG-SS",
                    options=options)
    x0 = 0.1 * np.random.default_rng(0).standard_normal(12)
    if moved is not None:
        x0 = x0 * (1 + np.asarray(moved) * np.finfo(np.float64).eps)
    res = jax.jit(lambda x: ctrl.run(x, steps=steps))(jnp.asarray(x0))
    ee = plant.kinematics.ee_pos_xyz(res.X_applied[:6, -1])[:2]
    err = float(jnp.linalg.norm(ee - jnp.asarray([3.0, 2.0])))
    return err, float(jnp.max(jnp.abs(res.U_applied))), res


def _solve(plant, cost, cset, N, dt, method, options=None):
    solver = make_sqp(plant, cost, cset, N, dt, method=method, options=options)
    nx, nu = plant.nx, plant.nu
    return jax.jit(solver.solve)(jnp.zeros((nx, N)), jnp.zeros((nu, N - 1)))


def _sqp_fields(res):
    return dict(X=res.X, U=res.U, J=res.J, exit_sqp=res.exit_sqp,
                iters=res.sqp_iters)


def twolinks():
    plant = URDFPlant(robot=serial_arm(2))
    cost = UrdfCost(plant, jnp.eye(4), 100.0 * jnp.eye(4), 0.1 * jnp.eye(2),
                    jnp.array([0.5, 1.5, 0.0, 0.0]))
    opts = SQPOptions(expected_reduction_min=-100.0)
    return {m: _sqp_fields(_solve(plant, cost, None, 10, 0.1, m, opts))
            for m in ("N", "S", "PCG-J", "PCG-BJ", "PCG-SS")}


def quadratic():
    plant = URDFPlant(robot=serial_arm(2))
    cost = QuadraticCost(jnp.diag(jnp.array([1.0, 1.0, 0.1, 0.1])),
                         100.0 * jnp.eye(4), 0.1 * jnp.eye(2),
                         jnp.array([np.pi / 4, -np.pi / 3, 0.0, 0.0]))
    cset = ConstraintSet(2, 2, 2, 10).with_torque_limits(7.0, -7.0,
                                                         "ACTIVE_SET")
    return {m: _sqp_fields(_solve(plant, cost, cset, 10, 0.1, m))
            for m in ("N", "S")}


def pendulum():
    N, dt = 20, 0.1
    plant = PendulumPlant()
    cost = QuadraticCost(jnp.eye(2), 100.0 * jnp.eye(2), 0.1 * jnp.eye(1),
                         jnp.array([np.pi, 0.0]))
    soft = ConstraintSet(1, 1, 1, N).with_torque_limits(
        [7.0], [-7.0], "AUGMENTED_LAGRANGIAN")
    hard = ConstraintSet(1, 1, 1, N).with_torque_limits(
        [7.0], [-7.0], "ACTIVE_SET", activation_band=0.2)
    hard_opts = SQPOptions(expected_reduction_min=-100.0, max_iter=40,
                           hard_violation_exit_tol=1e-3)
    out = {}
    for m in ("N", "S", "PCG-SS"):
        out[f"soft_{m}"] = _sqp_fields(_solve(plant, cost, soft, N, dt, m))
    for m in ("S", "PCG-SS"):
        out[f"hard_{m}"] = _sqp_fields(_solve(plant, cost, hard, N, dt, m,
                                              hard_opts))
    for m in ("iLQR", "QP-S"):
        ctrl = make_mpc(plant, cost, soft, N, dt, method=m)
        res = jax.jit(lambda x: ctrl.run(x, steps=PENDULUM_STEPS))(
            jnp.zeros(2))
        out[f"mpc_{m}"] = dict(X=res.X_applied, U=res.U_applied,
                               exit_codes=res.exit_codes, iters=res.iters)
    return out


def arm6():
    out = {}
    for limit in (0.0, 6.0):
        err, umax, res = mpc_arm6(ARM6_N, ARM6_STEPS, limit)
        out[f"limit{limit:g}"] = dict(X=res.X_applied, U=res.U_applied,
                                      exit_codes=res.exit_codes,
                                      iters=res.iters, ee_err=err,
                                      max_abs_u=umax)
    return out


def batch_sweep(n=2, N=10, method="PCG-SS"):
    plant = URDFPlant(robot=serial_arm(n))
    kdim = min(3, n)
    cost = UrdfCost(plant, jnp.eye(kdim + n), 100.0 * jnp.eye(kdim + n),
                    0.1 * jnp.eye(plant.nu), jnp.zeros(kdim + n))
    solver = make_sqp(plant, cost, None, N, 0.1, method=method,
                      options=SQPOptions(expected_reduction_min=-100.0))
    rng = np.random.default_rng(0)
    B = SWEEP_GOALS
    radii = 0.2 * n + 0.7 * n * rng.random(B)
    angs = 2 * np.pi * rng.random(B)
    goals = np.zeros((B, kdim + n))
    goals[:, 0] = radii * np.cos(angs)
    goals[:, 1] = radii * np.sin(angs)
    cps = jax.vmap(lambda g: cost.default_params._replace(xg=g))(
        jnp.asarray(goals))
    res = jax.jit(batch_solve(solver))(jnp.zeros((B, plant.nx, N)),
                                       jnp.zeros((B, plant.nu, N - 1)), cps)
    return {"sweep": dict(goals=goals, **_sqp_fields(res))}


def grid_row(n=2, dt=0.1, max_iter=20):
    kind, hess, integ, method, N, _ = GRID_ROW
    plant = URDFPlant(robot=serial_arm(n), integrator_type=integ)
    kdim = min(3, n)
    cost = UrdfCost(plant, jnp.eye(kdim + n), 100.0 * jnp.eye(kdim + n),
                    0.1 * jnp.eye(plant.nu), jnp.zeros(kdim + n),
                    hess_mode=hess)
    opts = SQPOptions(expected_reduction_min=-100.0, max_iter=max_iter,
                      exit_tolerance_linSys=1e-8, max_iter_linSys=100)
    solver = make_sqp(plant, cost, None, N, dt, method=method, options=opts)
    side = int(np.ceil(np.sqrt(2 * GRID_GOALS)))
    xs = np.linspace(-0.9 * n, 0.9 * n, side)
    pts = np.array([[x, y] for x in xs for y in xs
                    if x * x + y * y <= (0.9 * n) ** 2])
    goals_xy = pts[:GRID_GOALS]
    g = np.zeros((GRID_GOALS, kdim + n))
    g[:, :2] = goals_xy
    cps = jax.vmap(lambda gg: cost.default_params._replace(xg=gg))(
        jnp.asarray(g))
    fn = jax.jit(jax.vmap(lambda a, b, c: solver.solve(a, b, cost_params=c)))
    res = fn(jnp.zeros((GRID_GOALS, plant.nx, N)),
             jnp.zeros((GRID_GOALS, plant.nu, N - 1)), cps)
    return {"row": dict(goals=goals_xy, **_sqp_fields(res))}


EXAMPLES = {"twolinks": twolinks, "quadratic": quadratic,
            "pendulum": pendulum, "mpc_arm6": arm6,
            "batch_sweep": batch_sweep, "grid_sweep": grid_row}


def golden(path):
    arrays = {}
    for name, fn in EXAMPLES.items():
        for case, fields in fn().items():
            for field, v in fields.items():
                arrays[f"{name}/{case}/{field}"] = np.asarray(v)
        print(f"{name}: done", flush=True)
    np.savez_compressed(path, **arrays)
    print(f"wrote {len(arrays)} arrays to {path}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--golden", default=None)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--N", type=int, default=64)
    ap.add_argument("--moves", type=int, default=0)
    args = ap.parse_args()
    if args.golden:
        golden(args.golden)
        return
    base = None
    for limit in (0.0, 6.0):
        err, umax, res = mpc_arm6(args.N, args.steps, limit)
        base = res if base is None else base
        print(json.dumps({"example": "mpc_arm6", "N": args.N,
                          "steps": args.steps, "torque_limit": limit,
                          "dtype": "float64", "ee_err": err,
                          "max_abs_u": umax}), flush=True)
    for k in range(args.moves):
        s = 2 * np.random.default_rng(k).integers(0, 2, 12) - 1
        err, umax, res = mpc_arm6(args.N, args.steps, 0.0, moved=s)
        gap = np.abs(np.asarray(res.X_applied) - np.asarray(base.X_applied))
        gap = gap.max(0)
        first = lambda v: int(np.argmax(gap > v)) if (gap > v).any() else None
        print(json.dumps({"example": "mpc_arm6", "moved_x0_seed": k,
                          "ee_err": err, "max_abs_u": umax,
                          "state_gap_step1": float(gap[1]),
                          "first_step_gap_1e-3": first(1e-3),
                          "first_step_gap_0.1": first(0.1)}), flush=True)


if __name__ == "__main__":
    main()
