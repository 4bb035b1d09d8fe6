"""Whether bf16 inverses lose the flagship's cold-start solution in the port
or in the method: the port's fused-PCG plain version and the JAX package's
Pallas kernel (interpret mode, the same packed operands) on one of the
flagship's own cold Schur systems, on the CPU.

The system is the PCG-SS flagship's first QP at rho = 1e-3 (N = 64, bs =
12, bench scenario 0, assembled by the port in f32, as chip_smoke.py's
phase 23 assembles it at B = 512), its packed inverses stored in bf16 (SS,
the true-residual exit, the solver's relative 1e-4).  Prints one JSON
line per comparison: port against JAX after 5 and 40 iterations in f64
and in f32 (max|d|/max|x|, the iteration counts), each one's distance to
the exact solution (cyclic reduction in f64) beside inverses stored in
the operands' own type,
the port's own spread when r0 moves by one ulp, and the eigenvalues of
the diagonal blocks and of their bf16 inverses.

    JAX_PLATFORMS=cpu python tests/pcg_bf16_reference.py

tests/test_torch_pcg_dtypes.py holds the same comparison at 5 iterations
in f64 (one JAX compile) and the method's loss on the port alone.
"""

import json
import os
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

N, BS = 64, 12


def cold_system():
    """The flagship's cold Schur system (f32, B = 1) and the solver's PCG
    settings: (S, gam, kw)."""
    from trajoptmpcreference_tpu_torch import flagship as F
    from trajoptmpcreference_tpu_torch.solvers.sqp import knot_params
    x0s_np, goals_np = F.bench_scenarios(1)
    dt = torch.float32
    x0s = torch.as_tensor(x0s_np, dtype=dt)
    goals = torch.as_tensor(goals_np, dtype=dt)
    X0 = x0s[..., None].expand(1, 12, N).contiguous()
    U0 = torch.zeros((1, 6, N - 1), dtype=dt)
    _, cost, solver = F.flagship(N=N, dtype=dt, device="cpu",
                                 use_kernel_pcg=True, **F.PCG_KNOBS)
    kkt, o = solver.kkt, solver.options
    p = knot_params(cost.default_params._replace(xg=goals))
    blocks = kkt.form_blocks(X0, U0, x0s, p, ())
    S, gam, _, _ = kkt._schur_blocks_split(
        blocks, torch.full((1,), o.rho_init, dtype=dt))
    return S, gam, dict(precond="SS", tol=o.exit_tolerance_linSys,
                        max_iter=o.max_iter_linSys, relative=o.pcg_relative)


def operands(S, gam, dtype, precond_dtype=torch.bfloat16):
    """The fused PCG's packed operands in ``dtype``, the inverses stored
    in ``precond_dtype``."""
    from trajoptmpcreference_tpu_torch.ops import btridiag as BT
    from trajoptmpcreference_tpu_torch.ops import fused_pcg as FP
    d, u, p, r = FP.pack_operands(
        BT.BlockTridiag(S.diag.to(dtype), S.upper.to(dtype)),
        gam.to(dtype), "SS")
    return d, u, p.to(precond_dtype), r


def jax_kernel(ops, kw):
    """JAX's _pcg_kernel in interpret mode on the same packed operands
    (one scenario, its lane layout): (x (N, bs), iterations)."""
    import jax.numpy as jnp
    from trajoptmpcreference_tpu.ops.pallas_pcg import (
        _pallas_pcg_lanes,
        _tri_indices,
    )

    def lanes(t):   # one scenario's operand, the knot axis last, one lane
        if t.dtype == torch.bfloat16:   # numpy has no bf16: through f32
            return jnp.moveaxis(jnp.asarray(t[0].float().numpy()).astype(
                jnp.bfloat16), 0, -1)[..., None]
        return jnp.moveaxis(jnp.asarray(t[0].numpy()), 0, -1)[..., None]

    d, u, p, r = ops
    x, it = _pallas_pcg_lanes(
        lanes(d), lanes(u), lanes(p), lanes(r), bs=BS,
        pos=_tri_indices(BS)[2], tol=kw["tol"], max_iter=kw["max_iter"], block_b=128, interpret=True,
        precond="SS", relative=kw["relative"],
        true_residual_exit=p.dtype != r.dtype)
    return np.asarray(x)[..., 0].T, int(np.asarray(it)[0])


def main() -> int:
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from trajoptmpcreference_tpu_torch.ops import btridiag as BT
    from trajoptmpcreference_tpu_torch.ops import fused_pcg as FP
    S, gam, kw = cold_system()
    exact = BT.btd_cyclic_reduction(
        BT.BlockTridiag(S.diag.double(), S.upper.double()),
        gam.double())[0].numpy()
    rel = lambda a, b: float(np.abs(a - b).max() / np.abs(b).max())
    for dt in (torch.float64, torch.float32):
        for k in (5, kw["max_iter"]):
            kwk = dict(kw, max_iter=k)
            ops = operands(S, gam, dt)
            x, it = FP.pcg_fused_plain(*ops, **kwk)
            jx, jit_ = jax_kernel(ops, kwk)
            x = x[0].double().numpy()
            line = {"operands": str(dt)[6:], "inverses": "bfloat16",
                    "iterations": k, "port_iters": int(it[0]),
                    "jax_iters": jit_, "port_vs_jax": rel(x, jx)}
            if k == kw["max_iter"]:
                xf, _ = FP.pcg_fused_plain(*operands(S, gam, dt, dt), **kwk)
                line.update(port_gap=rel(x, exact), jax_gap=rel(jx, exact),
                            port_gap_own_inverses=rel(
                                xf[0].double().numpy(), exact))
                d, u, p, r = ops
                g = torch.Generator().manual_seed(0)
                sign = (2 * torch.randint(0, 2, r.shape, generator=g)
                        - 1).to(dt)
                xm, _ = FP.pcg_fused_plain(
                    d, u, p, r * (1 + sign * torch.finfo(dt).eps), **kwk)
                line["port_one_ulp_spread"] = rel(xm[0].double().numpy(), x)
            print(json.dumps(line), flush=True)
    d, _, p, _ = operands(S, gam, torch.float64)
    ev_d = torch.linalg.eigvalsh(FP._unpack_sym(d, BS)[0])
    ev_p = torch.linalg.eigvalsh(FP._unpack_sym(p.double(), BS)[0])
    print(json.dumps({
        "diag_blocks_eig": [float(ev_d.min()), float(ev_d.max())],
        "diag_blocks_cond_max": float((ev_d.abs().amax(-1)
                                       / ev_d.abs().amin(-1)).max()),
        "bf16_inverse_eig": [float(ev_p.min()), float(ev_p.max())],
        "bf16_inverse_blocks_with_positive_eig": int(
            (ev_p.amax(-1) > 0).sum())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
