"""The port's iLQR flagship closed loop against the JAX package (f64, CPU).

``F.run_episode(..., **F.ILQR_KNOBS)`` at B = 4 scenarios of bench.py,
N = 8, 4 steps (one cold step: 4 iterations, the 9-rung ladder; then 3
steady steps: 5 iterations, the 3-rung ladder), against ``jax.vmap`` of
``run_scheduled`` over ``__graft_entry__._flagship_mpc(method="iLQR")``
built the same way with the Pallas kernels off.  Iteration counts and exit
codes must be equal; applied states and controls and the solve costs agree
to 1e-6 relative to their largest entry.  Every step runs its whole budget
from a 3.6 m goal distance, and the cold start's rounding (the two
packages' batched LAPACK calls differ at ~1e-16) reaches the applied
controls at ~2e-8 (the port's own two backward passes differ by ~2e-6
over the same episode), so the bar is wider than a single solve's 1e-8.
A file of its own: the JAX episode's compile takes ~90 s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from __graft_entry__ import _flagship_mpc
from trajoptmpcreference_tpu.solvers.mpc import run_scheduled as jax_run_scheduled
from trajoptmpcreference_tpu_torch import flagship as F

jax.config.update("jax_enable_x64", True)

N, B, STEPS = 8, 4, 4
JAX_KW = dict(N=N, dtype=jnp.float64, use_pallas=False, use_pallas_fd=False,
              use_pallas_task=False)


def rel(out, ref):
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return float(np.abs(out.numpy() - ref).max() / np.abs(ref).max())


def test_ilqr_flagship_episode_matches_jax():
    _, jcost, jctrl = _flagship_mpc(**JAX_KW, **F.ILQR_KNOBS)
    _, _, jcold = _flagship_mpc(**JAX_KW, **{**F.ILQR_KNOBS, **F.COLD_KNOBS})
    x0s, goals = F.bench_scenarios(B)
    cps = jax.vmap(lambda g: jcost.default_params._replace(xg=g))(
        jnp.asarray(goals))
    ref = jax.jit(jax.vmap(lambda x0, cp: jax_run_scheduled(
        [(jcold, 1), (jctrl, STEPS - 1)], x0, cost_params=cp)))(
            jnp.asarray(x0s), cps)
    plant, res = F.run_episode(torch.tensor(x0s), torch.tensor(goals),
                               steps=STEPS, cold_steps=1, N=N, **F.ILQR_KNOBS)
    assert res.X_applied.shape == (B, 12, STEPS + 1)
    np.testing.assert_array_equal(res.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_array_equal(res.exit_codes.numpy(),
                                  np.asarray(ref.exit_codes))
    for field in ("X_applied", "U_applied", "J_solve"):
        assert rel(getattr(res, field), getattr(ref, field)) < 1e-6, field
    assert res.lam_last.shape == (B, 0)
    # the steps run iLQR: the cold step's budget is 4 iterations, the
    # steady steps' 5 (the counter stops at the budget's last index)
    assert int(res.iters[:, 0].max()) <= 3 and int(res.iters.max()) <= 4
