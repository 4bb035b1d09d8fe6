"""Shared example runners (the JAX package's examples/example_helpers.py,
itself the reference's exampleHelpers.py re-imagined).

runSQPExample / runMPCExample time one solve (or one closed loop) per
solver method after a first call that builds the kernels and caches (the
JAX runners' compile call), and optionally record the results to .npz.
Every problem is one scenario: the port's solvers take the scenario batch
as a leading axis, here of size 1.
"""

from __future__ import annotations

import argparse
import pathlib
from typing import Sequence

import numpy as np
import torch

from trajoptmpcreference_tpu_torch.convert import require_device
from trajoptmpcreference_tpu_torch.solvers.mpc import MPC_METHODS, make_mpc
from trajoptmpcreference_tpu_torch.solvers.sqp import make_sqp
from trajoptmpcreference_tpu_torch.utils.timing import time_fn

DTYPES = {"float64": torch.float64, "float32": torch.float32}


def parser(doc: str) -> argparse.ArgumentParser:
    """An argument parser with the examples' two port options: the device
    (the card unless asked; a CUDA device raises without CUDA) and the
    dtype (float64 unless asked)."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu to run on the CPU)")
    ap.add_argument("--dtype", default="float64", choices=sorted(DTYPES))
    return ap


def setting(args) -> dict:
    """dict(device=..., dtype=...) from parsed arguments."""
    return dict(device=require_device(args.device), dtype=DTYPES[args.dtype])


def tensors(device, dtype):
    """A maker of tensors on ``device`` in ``dtype`` from numbers."""
    return lambda a: torch.as_tensor(np.asarray(a, dtype=float), dtype=dtype,
                                     device=device)


def _like(cost):
    """The cost's dtype and device (its default parameters')."""
    Q = cost.default_params[0]
    return dict(dtype=Q.dtype, device=Q.device)


def _record(out_dir, n_test, name, **arrays):
    d = pathlib.Path(out_dir) / str(n_test)
    d.mkdir(parents=True, exist_ok=True)
    np.savez(d / name, **arrays)


def _np(t):
    return t.detach().cpu().numpy()


def runSQPExample(plant, cost, constraints, N, dt, methods: Sequence[str],
                  options=None, x0=None, u0=None, record: bool = False,
                  out_dir: str = "data", n_test: int = 0, verbose=True,
                  warmup: int = 1):
    """Run one SQP solve per method, timed after ``warmup`` untimed ones
    (the JAX runner's compile call); returns {method: (result, wall_s)}.
    x0 (nx, N) and u0 (nu, N-1) default to zeros.

    (ref: exampleHelpers.py:161-170 runSQPExample / :61-159 runSolversSQP)
    """
    nx, nu = plant.nx, plant.nu
    like = _like(cost)
    x0 = torch.zeros((nx, N), **like) if x0 is None else x0
    u0 = torch.zeros((nu, N - 1), **like) if u0 is None else u0
    out = {}
    for method in methods:
        solver = make_sqp(plant, cost, constraints, N, dt, method=method,
                          options=options)
        wall, res = time_fn(solver.solve, x0[None], u0[None], reps=1,
                            warmup=warmup)
        out[method] = (res, wall)
        if verbose:
            print(f"[{method:8s}] exit=({int(res.exit_sqp[0])},"
                  f"{int(res.exit_soft[0])}) iters={int(res.sqp_iters[0])} "
                  f"J={float(res.J[0]):.6f} viol={float(res.viol[0]):.2e} "
                  f"wall={wall*1e3:.2f}ms")
        if record:
            _record(out_dir, n_test, f"sqp_{method.replace('-', '_')}.npz",
                    x=_np(res.X[0]), u=_np(res.U[0]), J=float(res.J[0]),
                    viol=float(res.viol[0]), exit_sqp=int(res.exit_sqp[0]),
                    exit_soft=int(res.exit_soft[0]),
                    iters=int(res.sqp_iters[0]), wall_s=wall)
    return out


def runMPCExample(plant, cost, constraints, N, dt, methods: Sequence[str],
                  steps: int = 50, options=None, x0=None, record=False,
                  out_dir="data", n_test=0, verbose=True, warmup: int = 1):
    """Closed-loop MPC per method, timed after ``warmup`` untimed runs;
    returns {method: (MPCResult, wall_s)}.  x0 (nx,) defaults to zeros.

    Restores the API the reference's pendulum example calls but never
    defines (ref: examples/pendulum.py:28)."""
    x0 = torch.zeros(plant.nx, **_like(cost)) if x0 is None else x0
    out = {}
    for method in methods:
        assert method in MPC_METHODS, method
        ctrl = make_mpc(plant, cost, constraints, N, dt, method=method,
                        options=options)
        wall, res = time_fn(lambda x: ctrl.run(x, steps=steps), x0[None],
                            reps=1, warmup=warmup)
        out[method] = (res, wall)
        if verbose:
            print(f"[{method:9s}] {steps} steps in {wall*1e3:.1f}ms "
                  f"({steps/wall:.1f} steps/s)  final x = "
                  f"{_np(res.X_applied[0, :, -1]).round(4)}")
        if record:
            _record(out_dir, n_test, f"mpc_{method.replace('-', '_')}.npz",
                    x=_np(res.X_applied[0]), u=_np(res.U_applied[0]),
                    exit_codes=_np(res.exit_codes[0]), wall_s=wall)
    return out

