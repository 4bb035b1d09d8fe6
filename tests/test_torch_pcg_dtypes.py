"""K4's storage dtypes against the JAX package.

``make_batched_pcg(..., precond_dtype, operator_dtype)`` stores the packed
diagonal blocks and / or their inverses narrower than the operands
(pallas_pcg.py:365-368) and, with a narrow preconditioner, exits on the
true residual r'r (:335-336).  The port's plain version (CPU tensors) is
held to JAX's Pallas kernel in interpret mode (its own CPU route) for J,
BJ and SS with bf16 and f16 storage, alone and together: B = 1 (JAX's
tile is then the scenario, so the iteration counts compare one to one),
N = 8, bs = 4, f32, 1e-5 of max|x| with equal iteration counts; and f32
storage under f64 operands at 1e-10.  Inputs are numpy, from seeds.  On
one of the flagship's own cold Schur systems (N = 64, bs = 12) with bf16
inverses the two agree at 1e-10 in f64 (tests/pcg_bf16_reference.py
prints the whole comparison), and the solution is lost by the method,
not the port: the bf16-rounded inverses of those negative-definite
blocks are indefinite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcg_bf16_reference import cold_system, jax_kernel, operands
from trajoptmpcreference_tpu.ops import btridiag as jbtd
from trajoptmpcreference_tpu.ops.pallas_pcg import make_batched_pcg as jax_batched_pcg
from trajoptmpcreference_tpu_torch.ops import btridiag as tbtd
from trajoptmpcreference_tpu_torch.ops import fused_pcg as FP

N, BS = 8, 4
TORCH = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32,
         None: None}
JAX = {"bf16": jnp.bfloat16, "f16": jnp.float16, "f32": jnp.float32,
       None: None}


def _system(seed, scale=1.0):
    """One SPD block-tridiagonal system (N = 8, bs = 4), its right-hand
    side and a warm start, as numpy; the diagonal blocks are scaled by
    ``scale``."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((N, BS, BS))
    diag = scale * (M @ np.swapaxes(M, -1, -2) + 2.0 * BS * np.eye(BS))
    upper = 0.6 * rng.standard_normal((N - 1, BS, BS))
    return diag, upper, rng.standard_normal((N, BS)), \
        0.1 * rng.standard_normal((N, BS))


def _jax(diag, upper, b, guess, dtype, kw, precond_dtype, operator_dtype):
    solve = jax_batched_pcg(N, BS, interpret=True, precond_dtype=precond_dtype,
                            operator_dtype=operator_dtype, **kw)
    j = lambda a: jnp.asarray(a, dtype=dtype)
    x, it = solve(jbtd.BlockTridiag(j(diag), j(upper)), j(b), j(guess))
    return np.asarray(x), int(np.asarray(it))


def _torch(diag, upper, b, guess, dtype, kw, precond_dtype, operator_dtype):
    solve = FP.make_batched_pcg(N, BS, precond_dtype=precond_dtype,
                                operator_dtype=operator_dtype, **kw)
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype)[None]
    x, it = solve(tbtd.BlockTridiag(t(diag), t(upper)), t(b), t(guess))
    return x[0].numpy(), int(it[0])


@pytest.mark.parametrize("precond", ["J", "BJ", "SS"])
@pytest.mark.parametrize("pre,op", [("bf16", None), ("f16", None),
                                    (None, "bf16"), (None, "f16"),
                                    ("bf16", "bf16"), ("f16", "f16")])
def test_storage_matches_pallas_interpret(pre, op, precond):
    """bf16 / f16 storage of the inverses, of the blocks, or of both, f32
    operands, relative exit 1e-8 (on r'r where the inverses are narrow,
    on nu otherwise): the port's plain version and JAX's kernel in
    interpret mode agree to 1e-5 of max|x| with equal iteration counts."""
    diag, upper, b, guess = _system(seed=3)
    kw = dict(precond=precond, tol=1e-8, max_iter=60, relative=True)
    jx, jit_ = _jax(diag, upper, b, guess, jnp.float32, kw, JAX[pre], JAX[op])
    x, it = _torch(diag, upper, b, guess, torch.float32, kw, TORCH[pre],
                   TORCH[op])
    assert it == jit_
    assert float(np.abs(x - jx).max() / np.abs(jx).max()) < 1e-5


@pytest.mark.parametrize("precond", ["BJ", "SS"])
def test_f32_storage_under_f64_matches_pallas_interpret(precond):
    """f32 storage of the inverses and the blocks under f64 operands (the
    true-residual exit): 1e-10 of max|x|, equal iteration counts."""
    diag, upper, b, guess = _system(seed=5)
    kw = dict(precond=precond, tol=1e-20, max_iter=80, relative=True)
    jx, jit_ = _jax(diag, upper, b, guess, jnp.float64, kw, jnp.float32,
                    jnp.float32)
    x, it = _torch(diag, upper, b, guess, torch.float64, kw, torch.float32,
                   torch.float32)
    assert it == jit_
    assert float(np.abs(x - jx).max() / np.abs(jx).max()) < 1e-10


def test_operator_storage_alone_exits_on_nu():
    """With only the blocks stored narrow the exit metric stays nu = r's:
    on blocks scaled by 1e3 (nu ~ r'r / 1e4) and an absolute tolerance,
    the solve stops where nu falls under it while r'r is still far above,
    as JAX's kernel does (same count); with the inverses stored narrow as
    well it runs on until r'r falls under the tolerance."""
    diag, upper, b, guess = _system(seed=7, scale=1e3)
    kw = dict(precond="SS", tol=1e-6, max_iter=60, relative=False)
    S = tbtd.BlockTridiag(torch.tensor(diag)[None], torch.tensor(upper)[None])

    def residual_sq(x):
        r = torch.tensor(b)[None] - tbtd.btd_matvec(
            S, torch.tensor(x, dtype=torch.float64)[None])
        return float((r * r).sum())

    x, it = _torch(diag, upper, b, guess, torch.float32, kw, None,
                   torch.bfloat16)
    _, jit_ = _jax(diag, upper, b, guess, jnp.float32, kw, None, jnp.bfloat16)
    assert it == jit_
    assert residual_sq(x) > 100 * kw["tol"]
    x2, it2 = _torch(diag, upper, b, guess, torch.float32, kw, torch.bfloat16,
                     torch.bfloat16)
    _, jit2 = _jax(diag, upper, b, guess, jnp.float32, kw, jnp.bfloat16,
                   jnp.bfloat16)
    assert it2 == jit2 and it2 > it


def test_wider_storage_raises():
    """A storage dtype wider than the operands' raises TypeError, in the
    solver and in the plain version (JAX would promote the whole solve to
    it); storage equal to the operands' is their own (code 0)."""
    diag, upper, b, guess = _system(seed=9)
    kw = dict(precond="SS", tol=1e-8, max_iter=60, relative=True)
    for pre, op in ((torch.float64, None), (None, torch.float64)):
        with pytest.raises(TypeError, match="wider"):
            _torch(diag, upper, b, guess, torch.float32, kw, pre, op)
    S = tbtd.BlockTridiag(torch.tensor(diag)[None].float(),
                          torch.tensor(upper)[None].float())
    ops = FP.pack_operands(S, torch.tensor(b)[None].float(), "SS")
    with pytest.raises(TypeError, match="wider"):
        FP.pcg_fused_plain(ops[0], ops[1], ops[2].double(), ops[3], **kw)
    assert FP.storage_code(torch.float64, torch.float64) == 0
    assert FP.storage_code(torch.float32, torch.float64) == 1
    x, it = _torch(diag, upper, b, guess, torch.float32, kw, torch.float32,
                   None)
    x0, it0 = _torch(diag, upper, b, guess, torch.float32, kw, None, None)
    assert it == it0 and np.array_equal(x, x0)


def test_bf16_inverses_on_the_flagship_cold_system():
    """The PCG-SS flagship's cold Schur system (its first QP, N = 64, bs =
    12, bench scenario 0; pcg_bf16_reference.cold_system), widened to f64
    with its packed inverses stored in bf16 (SS, the true-residual exit,
    relative 1e-4): after 5 fixed iterations the port's plain version and
    JAX's kernel in interpret mode agree to 1e-10 of max|x| with equal
    counts (one JAX compile).  The loss of the solution is the method's:
    every diagonal block is negative definite (condition up to ~6e7), and
    its bf16-rounded inverse has a positive eigenvalue, so the
    preconditioner is indefinite; at the solver's 40 iterations the port
    ends over half the solution's scale from it (cyclic reduction in f64)
    with bf16 inverses, and under a third with the inverses in f64."""
    S, gam, kw = cold_system()
    ops = operands(S, gam, torch.float64)
    fixed = dict(kw, max_iter=5)
    x, it = FP.pcg_fused_plain(*ops, **fixed)
    jx, jit_ = jax_kernel(ops, fixed)
    assert int(it[0]) == jit_ == 5
    x = x[0].numpy()
    assert float(np.abs(x - jx).max() / np.abs(jx).max()) < 1e-10
    d, _, p, _ = ops
    ev_d = torch.linalg.eigvalsh(FP._unpack_sym(d, 12)[0])
    ev_p = torch.linalg.eigvalsh(FP._unpack_sym(p.double(), 12)[0])
    assert bool((ev_d < 0).all())
    assert bool((ev_p.amax(-1) > 0).any())
    exact = tbtd.btd_cyclic_reduction(
        tbtd.BlockTridiag(S.diag.double(), S.upper.double()), gam.double())
    gap = lambda x: float((x - exact).abs().max() / exact.abs().max())
    x_bf16, _ = FP.pcg_fused_plain(*ops, **kw)
    x_own, _ = FP.pcg_fused_plain(*operands(S, gam, torch.float64,
                                            torch.float64), **kw)
    assert gap(x_bf16) > 0.5 and gap(x_own) < 0.3, (gap(x_bf16), gap(x_own))
