"""The scenarios of a traffic mix, made from the run's seed.

Episode e of a run solves B scenarios drawn as bench.py:192-197 draws
them (``flagship.bench_scenarios``, copied here): initial states x0_std
N(0, 1) in every coordinate and goals goal_xy + goal_std N(0, 1) in x-y,
from ``numpy.random.default_rng([seed, e])``.  Every seed gives the same
sizes (B scenarios, ``episode_steps`` steps an episode) and a fresh draw
of the same distribution; the same seed gives the same scenarios."""

from __future__ import annotations

import numpy as np


def episode(traffic: dict, seed: int, e: int):
    """(x0s (B, nx), goals (B, 6)) float64 of episode e of the seed."""
    B, nx = traffic["batch"], traffic["state_dim"]
    rng = np.random.default_rng([seed % 2**64, e])
    x0s = traffic["x0_std"] * rng.standard_normal((B, nx))
    xy = np.array(traffic["goal_xy"] + [0.0])
    goals = np.concatenate([
        xy + traffic["goal_std"] * rng.standard_normal((B, 3)) * [1, 1, 0],
        np.zeros((B, 3))], axis=1)
    return x0s, goals
