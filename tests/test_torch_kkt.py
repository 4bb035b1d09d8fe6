"""Port's KKT assembly and exact Schur solves vs the JAX package (f64,
6-DoF flagship arm, N = 8, B = 3 scenarios).

Each stage takes the same inputs on both sides (the JAX blocks feed the
port's Schur assembly, the JAX Schur system feeds the port's solvers), so
every comparison isolates one function.  Tolerances, as max |port - jax| /
max |jax| in f64: 1e-10 for the KKT blocks (the same arithmetic, sums
reassociated); 1e-8 for the Schur assembly, whose block inverses of the
Gauss-Newton Hessian (condition ~1e6 at rho = 1e-3) amplify the LU
rounding of the two libraries to ~kappa * eps; 1e-6 for the multipliers of
the Schur system itself (condition up to ~1e9), whose backward error
max|S lam - gam| / (max|S| max|lam|) must also stay below 1e-12."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship
from trajoptmpcreference_tpu.ops import btridiag as jbtd
from trajoptmpcreference_tpu_torch import flagship as F
from trajoptmpcreference_tpu_torch.ops import btridiag as tbtd
from trajoptmpcreference_tpu_torch.solvers.kkt import KKTBlocks
from trajoptmpcreference_tpu_torch.solvers.sqp import knot_params

N, B = 8, 3
TOL_BLOCKS, TOL_SCHUR, TOL_LAM = 1e-10, 1e-8, 1e-6


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.fixture(scope="module")
def systems():
    rng = np.random.default_rng(5)
    X = 0.3 * rng.standard_normal((B, 12, N))
    U = 0.3 * rng.standard_normal((B, 6, N - 1))
    xs = X[:, :, 0] + 0.01 * rng.standard_normal((B, 12))
    goals = F.bench_scenarios(B)[1]
    rho = np.array([1e-3, 4e-3, 1e-2])
    _, jcost, jsolver = _flagship(N=N, dtype=jnp.float64, use_pallas=False,
                                  use_pallas_fd=False, use_pallas_task=False)
    jkkt = jsolver.kkt
    cps = jax.vmap(lambda g: jcost.default_params._replace(xg=g))(
        jnp.asarray(goals))
    jblocks = jax.jit(jax.vmap(lambda x, u, s, p: jkkt.form_blocks(
        x, u, s, p, ())))(jnp.asarray(X), jnp.asarray(U), jnp.asarray(xs), cps)
    jschur = jax.jit(jax.vmap(jkkt._schur_blocks_split))(jblocks,
                                                         jnp.asarray(rho))
    _, tcost, tsolver = F.flagship(N=N, dtype=torch.float64, device="cpu")
    return dict(X=X, U=U, xs=xs, goals=goals, rho=rho, jblocks=jblocks,
                jschur=jschur, tcost=tcost, tkkt=tsolver.kkt)


def test_form_blocks_matches_jax(systems):
    s = systems
    t = torch.tensor
    params = knot_params(s["tcost"].default_params._replace(xg=t(s["goals"])))
    blocks = s["tkkt"].form_blocks(t(s["X"]), t(s["U"]), t(s["xs"]), params, ())
    for field in ("H", "g", "A", "B", "defect"):
        assert _rel(getattr(blocks, field),
                    getattr(s["jblocks"], field)) < TOL_BLOCKS, field
    assert blocks.hval.shape == (B, N, 0) and blocks.hjac.shape == (B, N, 0, 18)


def test_schur_blocks_split_matches_jax(systems):
    s = systems
    jb = s["jblocks"]
    blocks = KKTBlocks(*(torch.tensor(np.asarray(a)) for a in jb))
    S, gam, iGxx, iGuu = s["tkkt"]._schur_blocks_split(blocks,
                                                       torch.tensor(s["rho"]))
    jS, jgam, jiGxx, jiGuu = s["jschur"]
    for name, a, b in (("diag", S.diag, jS.diag), ("upper", S.upper, jS.upper),
                       ("gam", gam, jgam), ("iGxx", iGxx, jiGxx),
                       ("iGuu", iGuu, jiGuu)):
        assert _rel(a, b) < TOL_SCHUR, name


@pytest.mark.parametrize("solver", ["cr", "thomas"])
def test_exact_schur_solvers_match_jax(systems, solver):
    jS, jgam = systems["jschur"][:2]
    jfn = {"cr": jbtd.btd_cyclic_reduction, "thomas": jbtd.btd_block_thomas}[solver]
    tfn = {"cr": tbtd.btd_cyclic_reduction, "thomas": tbtd.btd_block_thomas}[solver]
    ref = np.asarray(jax.jit(jax.vmap(jfn))(jS, jgam))
    S = tbtd.BlockTridiag(torch.tensor(np.asarray(jS.diag)),
                          torch.tensor(np.asarray(jS.upper)))
    lam = tfn(S, torch.tensor(np.asarray(jgam)))
    assert _rel(lam, ref) < TOL_LAM
    res = tbtd.btd_matvec(S, lam) - torch.tensor(np.asarray(jgam))
    scale = float(S.diag.abs().max()) * float(lam.abs().max())
    assert float(res.abs().max()) < 1e-12 * scale


def test_cyclic_reduction_pads_non_power_of_two():
    """N = 5 pads to 8 with identity blocks; CR equals Thomas and a dense
    solve of the same (batched) system."""
    rng = np.random.default_rng(2)
    Bn, n, bs = 2, 5, 4
    M = rng.standard_normal((Bn, n, bs, bs))
    diag = M @ np.swapaxes(M, -1, -2) + 4 * np.eye(bs)
    upper = 0.3 * rng.standard_normal((Bn, n - 1, bs, bs))
    b = rng.standard_normal((Bn, n, bs))
    S = tbtd.BlockTridiag(torch.tensor(diag), torch.tensor(upper))
    x_cr = tbtd.btd_cyclic_reduction(S, torch.tensor(b))
    x_th = tbtd.btd_block_thomas(S, torch.tensor(b))
    for k in range(Bn):
        dense = np.asarray(jbtd.btd_dense(jbtd.BlockTridiag(
            jnp.asarray(diag[k]), jnp.asarray(upper[k]))))
        ref = np.linalg.solve(dense, b[k].reshape(-1)).reshape(n, bs)
        np.testing.assert_allclose(x_cr[k].numpy(), ref, atol=1e-12)
        np.testing.assert_allclose(x_th[k].numpy(), ref, atol=1e-12)
