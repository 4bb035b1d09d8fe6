"""The port's torque-limited flagship solve, stacked ACTIVE_SET+AL mode, against the
JAX package (f64 on the CPU).

The reference's stacked recipe (__graft_entry__.py:150-170: hard
ACTIVE_SET rows with an activation band of 0.2 and an AL limit on the same
bound; the condensed Schur path) with ``AS_KNOBS``' 4 SQP iterations,
a budget of three AL outer rounds a solve, and the limit lowered from 6
to 2 so that it binds at this horizon; N = 8, B = 3 scenarios of bench.py, against ``jax.vmap`` of
``__graft_entry__._flagship`` with the same knobs and the Pallas kernels
off: equal exit codes, iteration counts and outer rounds, controls to
1e-7 (the bar of tests/test_torch_sqp_mpc.py), the soft state to 1e-9,
multipliers to 1e-5 of their largest.  A file of its own: the JAX solve's
compile takes ~80 s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from __graft_entry__ import _flagship
from trajoptmpcreference_tpu_torch import flagship as F

N, B = 8, 3
KNOBS = dict(F.AS_KNOBS, torque_mode="ACTIVE_SET+AL", torque_limit=2.0,
             max_iter_soft=3)


def test_as_al_flagship_solve_matches_jax():
    x0s, goals = F.bench_scenarios(B)
    X0 = np.repeat(x0s[:, :, None], N, axis=2)
    U0 = np.zeros((B, 6, N - 1))
    _, jcost, jsolver = _flagship(N=N, dtype=jnp.float64, use_pallas=False,
                                  use_pallas_fd=False, use_pallas_task=False,
                                  **KNOBS)
    cps = jax.vmap(lambda g: jcost.default_params._replace(xg=g))(
        jnp.asarray(goals))
    ref = jax.jit(jax.vmap(jsolver.solve))(jnp.asarray(X0), jnp.asarray(U0), cps)
    _, cost, solver = F.flagship(N=N, dtype=torch.float64, device="cpu", **KNOBS)
    assert solver.kkt._can_condense_hard()
    res = solver.solve(torch.tensor(X0), torch.tensor(U0),
                       cost.default_params._replace(xg=torch.tensor(goals)))
    for field in ("exit_sqp", "sqp_iters", "exit_soft", "outer_iters"):
        np.testing.assert_array_equal(getattr(res, field).numpy(),
                                      np.asarray(getattr(ref, field)), field)
    assert np.abs(res.U.numpy() - np.asarray(ref.U)).max() < 1e-7
    assert np.abs(res.X.numpy() - np.asarray(ref.X)).max() < 1e-7
    lam = np.asarray(ref.lam)
    assert res.lam.shape == lam.shape == (B, N, 12 + 12)
    assert np.abs(res.lam.numpy() - lam).max() < 1e-5 * np.abs(lam).max()
    for st, jst in zip(res.cstate, ref.cstate):
        for a, b in zip(st, jst):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9,
                                       atol=1e-9)
    # the hard rows, banded, hold every torque inside the bound, so the
    # AL limit on it sees no violation and its first round converges
    assert float(res.U.abs().max()) <= 2.0 + 1e-6
    assert res.outer_iters.tolist() == [0] * B
