"""The plain reference of ``sqp.py`` with the port's rule for where a
warm-started PCG starts, for a PCG-SS configuration that names it
(``"reference": "sqp_pcg_guard"``).

It is ``sqp.py`` loaded once more under its own name, with the PCG its
Newton steps call replaced by ``solve`` below: per scenario, the warm start
``guess`` is kept unless it gives an |nu_0| = |r0' Pinv r0| (r0 = gam - S
guess, Pinv the dense symmetric-stair preconditioner of ``pcg.py``) more
than ``NU_RATIO_MAX`` times the zero start's |gam' Pinv gam|; then the
iteration starts from zero.  Every other step is ``pcg.solve`` as before.

The rule is the port's (``ops/btridiag.warm_start``, which the port's three
PCG routes share) and a departure from the reference's upstream
(GBD-PCG-Python PCG.py:66-111) and from the JAX package, which start from
any guess.  It leaves the warm starts of multipliers in their usual range
alone; it drops one that a float32 solve on a nearly singular Schur system
has blown up, which would otherwise grow step after step until it
overflows.
The port compares the two in units scaled by a power of two, so that
float32 cannot overflow there; in float64 this needs no scaling.
"""

from __future__ import annotations

import importlib.util
import pathlib
import types

import torch

from reference import pcg

# the port's ``btridiag.WARM_START_NU_RATIO_MAX``
NU_RATIO_MAX = 2.0 ** 40


def solve(S: torch.Tensor, gam: torch.Tensor, guess: torch.Tensor, N: int,
          bs: int, iters: int, tol: float) -> torch.Tensor:
    """``pcg.solve`` from ``guess``, or from zero where the guess is more
    than ``NU_RATIO_MAX`` times worse than zero by |nu_0|."""
    mv = lambda M, v: (M @ v[..., None])[..., 0]
    P = pcg.stair_inverse(S, N, bs)
    r = gam - mv(S, guess)
    nu_guess = (r * mv(P, r)).sum(-1).abs()
    nu_zero = (gam * mv(P, gam)).sum(-1).abs()
    drop = (nu_guess > NU_RATIO_MAX * nu_zero)[:, None]
    start = torch.where(drop, torch.zeros_like(guess), guess)
    return pcg.solve(S, gam, start, N, bs, iters, tol)


def _sqp_with_this_pcg():
    spec = importlib.util.spec_from_file_location(
        "reference_sqp_pcg_guard_sqp",
        pathlib.Path(__file__).resolve().with_name("sqp.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.pcg = types.SimpleNamespace(solve=solve)
    return mod


_sqp = _sqp_with_this_pcg()
Problem, mpc_step, METHODS = _sqp.Problem, _sqp.mpc_step, _sqp.METHODS
