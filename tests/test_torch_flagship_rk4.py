"""The RK4 flagship (``flagship.RK4_KNOBS``, __graft_entry__._flagship's
``integrator_type=4``) against the JAX package: B = 4, N = 8, 2
closed-loop steps from bench.py's scenarios, f64, on the CPU, against
``jax.vmap`` of _flagship_mpc with the Pallas kernels off; states,
controls and solve costs to 1e-4 and equal iteration counts and exit
codes, as the semi-implicit flagship's episode (tests/test_torch_sqp_mpc.py).
One file of its own: tracing JAX's RK4 flagship takes ~2-3 minutes.
"""

import torch

from test_torch_flagship_knobs import _compare_loop
from trajoptmpcreference_tpu_torch import flagship as F


def test_rk4_flagship_matches_jax():
    res = _compare_loop(F.RK4_KNOBS, 2, 1e-4)
    assert bool(torch.isfinite(res.X_applied).all())
