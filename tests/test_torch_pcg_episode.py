"""The port's PCG-SS flagship closed loop against the JAX package.

A 3-step run_scheduled episode (1 cold step: 4 SQP iterations and the
9-rung ladder; 2 steady steps: 4 iterations and the 3-rung ladder; PCG-SS
with 40 iterations at a relative exit of 1e-4 in both) at N = 8, B = 3,
f64, against ``jax.vmap`` of the JAX run_scheduled over
__graft_entry__._flagship_mpc with the Pallas kernels off and the XLA
PCG: states and controls to 1e-4, equal iteration counts and exit codes.
The tolerance is wide of f64 roundoff for the reason given in
tests/test_torch_sqp_mpc.py (cold-start Schur systems of condition
~1e7-1e9).  It has a file of its own because the JAX episode's compile
alone takes about 100 s on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from __graft_entry__ import _flagship_mpc
from trajoptmpcreference_tpu.solvers.mpc import run_scheduled as jax_run_scheduled
from trajoptmpcreference_tpu_torch import flagship as F

N, B = 8, 3


def test_pcg_flagship_episode_matches_jax():
    x0s, goals = F.bench_scenarios(B)
    kw = dict(N=N, dtype=jnp.float64, use_pallas=False, use_pallas_fd=False,
              use_pallas_task=False, use_pallas_pcg=False, **F.PCG_KNOBS)
    _, jcost, jctrl = _flagship_mpc(**kw)
    _, _, jcold = _flagship_mpc(**{**kw, **F.COLD_KNOBS})
    cps = jax.vmap(lambda g: jcost.default_params._replace(xg=g))(
        jnp.asarray(goals))
    ref = jax.jit(jax.vmap(lambda x0, cp: jax_run_scheduled(
        [(jcold, 1), (jctrl, 2)], x0, cost_params=cp)))(jnp.asarray(x0s), cps)
    _, res = F.run_episode(torch.tensor(x0s), torch.tensor(goals), steps=3,
                           cold_steps=1, N=N, **F.PCG_KNOBS)
    assert res.X_applied.shape == (B, 12, 4)
    np.testing.assert_array_equal(res.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_array_equal(res.exit_codes.numpy(),
                                  np.asarray(ref.exit_codes))
    assert np.abs(res.X_applied.numpy() - np.asarray(ref.X_applied)).max() < 1e-4
    assert np.abs(res.U_applied.numpy() - np.asarray(ref.U_applied)).max() < 1e-4
