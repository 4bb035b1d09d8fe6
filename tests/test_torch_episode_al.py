"""The port's torque-limited flagship closed loop, AUGMENTED_LAGRANGIAN mode, against the
JAX package (f64 on the CPU).

A 5-step run_scheduled episode of ``flagship.AL_KNOBS`` (1 cold step: 4 SQP
iterations, the 9-rung ladder, block-Thomas; 4 steady steps: 4
iterations, the 3-rung ladder, cyclic reduction) with the limit lowered
from 6 to 2 so that it binds at N = 8, B = 3 scenarios of bench.py,
against ``jax.vmap`` of the JAX run_scheduled over
``__graft_entry__._flagship_mpc`` with the same knobs and the Pallas
kernels off: the bars of tests/test_torch_sqp_mpc.py's
test_flagship_episode_matches_jax (states and controls to 1e-4, equal
iteration counts and exit codes, multipliers to 1e-3), and the last soft
state to 1e-9.  A file of its own: the JAX episode's compile alone takes
~100 s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from __graft_entry__ import _flagship_mpc
from trajoptmpcreference_tpu.solvers.mpc import run_scheduled as jax_run_scheduled
from trajoptmpcreference_tpu_torch import flagship as F

N, B = 8, 3
KNOBS = dict(F.AL_KNOBS, torque_limit=2.0)


def test_al_flagship_episode_matches_jax():
    x0s, goals = F.bench_scenarios(B)
    kw = dict(N=N, dtype=jnp.float64, use_pallas=False, use_pallas_fd=False,
              use_pallas_task=False, **KNOBS)
    _, jcost, jctrl = _flagship_mpc(**kw)
    _, _, jcold = _flagship_mpc(**{**kw, **F.COLD_KNOBS})
    cps = jax.vmap(lambda g: jcost.default_params._replace(xg=g))(
        jnp.asarray(goals))
    ref = jax.jit(jax.vmap(lambda x0, cp: jax_run_scheduled(
        [(jcold, 1), (jctrl, 4)], x0, cost_params=cp)))(jnp.asarray(x0s), cps)
    _, res = F.run_episode(torch.tensor(x0s), torch.tensor(goals), steps=5,
                           cold_steps=1, N=N, **KNOBS)
    assert res.X_applied.shape == (B, 12, 6)
    np.testing.assert_array_equal(res.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_array_equal(res.exit_codes.numpy(),
                                  np.asarray(ref.exit_codes))
    assert np.abs(res.X_applied.numpy() - np.asarray(ref.X_applied)).max() < 1e-4
    assert np.abs(res.U_applied.numpy() - np.asarray(ref.U_applied)).max() < 1e-4
    np.testing.assert_allclose(res.lam_last.numpy(), np.asarray(ref.lam_last),
                               rtol=1e-3, atol=1e-3)
    assert len(res.cstate_last) == len(ref.cstate_last)
    for st, jst in zip(res.cstate_last, ref.cstate_last):
        for a, b in zip(st, jst):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9,
                                       atol=1e-9)
