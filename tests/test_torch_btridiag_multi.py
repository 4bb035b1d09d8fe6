"""The port's multi-RHS block-Thomas against the JAX package's, and the
single-RHS solve it now carries.

``btd_block_thomas_multi`` at B x N = 4 x 16, bs = 4, m = 9 against JAX's
(under vmap) in f64 at 1e-12 of max|x|.  ``btd_block_thomas`` is the
multi-RHS solve with one column; it is held bit for bit, in f32 and f64,
to the single-RHS loop it replaced (kept below as written before), since
it is the flagship's cold-step solve.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajoptmpcreference_tpu.ops import btridiag as jbtd
from trajoptmpcreference_tpu_torch.ops import btridiag as tbtd

B, N, BS, M = 4, 16, 4, 9


def _systems(seed):
    rng = np.random.default_rng(seed)
    diag = rng.standard_normal((B, N, BS, BS))
    diag = diag @ np.swapaxes(diag, -1, -2) + 4.0 * BS * np.eye(BS)
    upper = 0.3 * rng.standard_normal((B, N - 1, BS, BS))
    return diag, upper, rng.standard_normal((B, N, BS, M))


def _thomas_single(A, b):
    """The single-RHS block-Thomas loop as the port had it."""
    N, bs = A.nblocks, A.bs
    lead = A.diag.shape[:-3]
    zero_blk = A.diag.new_zeros(lead + (bs, bs))
    C, d = [], []
    for k in range(N):
        Dk = A.diag[..., k, :, :]
        Uk = A.upper[..., k, :, :] if k < N - 1 else zero_blk
        bk = b[..., k, :, None]
        if k == 0:
            Dt, dt = Dk, bk
        else:
            Lk = A.upper[..., k - 1, :, :].transpose(-1, -2)
            Dt = Dk - Lk @ C[-1]
            dt = bk - Lk @ d[-1]
        sol = tbtd._solve_batched(Dt, torch.cat([Uk, dt], dim=-1), spd=True)
        C.append(sol[..., :bs])
        d.append(sol[..., bs:])
    xs = [None] * N
    xs[N - 1] = d[N - 1]
    for k in range(N - 2, -1, -1):
        xs[k] = d[k] - C[k] @ xs[k + 1]
    return torch.stack(xs, dim=-3)[..., 0]


def test_multi_rhs_matches_jax():
    diag, upper, rhs = _systems(0)
    x = tbtd.btd_block_thomas_multi(
        tbtd.BlockTridiag(torch.tensor(diag), torch.tensor(upper)),
        torch.tensor(rhs)).numpy()
    ref = np.asarray(jax.jit(jax.vmap(
        lambda d, u, r: jbtd.btd_block_thomas_multi(jbtd.BlockTridiag(d, u), r)))(
            jnp.asarray(diag), jnp.asarray(upper), jnp.asarray(rhs)))
    assert x.shape == (B, N, BS, M)
    assert np.abs(x - ref).max() < 1e-12 * np.abs(ref).max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_single_rhs_unchanged_bit_for_bit(dtype):
    diag, upper, rhs = _systems(1)
    A = tbtd.BlockTridiag(torch.tensor(diag, dtype=dtype),
                          torch.tensor(upper, dtype=dtype))
    b = torch.tensor(rhs[..., 0], dtype=dtype)
    x = tbtd.btd_block_thomas(A, b)
    assert torch.equal(x, _thomas_single(A, b))
    assert torch.equal(x, tbtd.btd_block_thomas_multi(A, b[..., None])[..., 0])
    # each column of the stacked solve is that column's own solve
    X = tbtd.btd_block_thomas_multi(A, torch.tensor(rhs, dtype=dtype))
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    for j in (0, M - 1):
        xj = tbtd.btd_block_thomas(A, torch.tensor(rhs[..., j], dtype=dtype))
        assert float((X[..., j] - xj).abs().max()) < tol * float(xj.abs().max())
