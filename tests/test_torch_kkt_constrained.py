"""The port's constrained KKT assembly and Schur solves against the JAX
package, f64 on the CPU.

The configuration is tests/test_btridiag.py::test_condensed_schur_matches_generic's
(3-link arm, N = 12, dt = 0.05, controls straddling a +-0.5 torque limit so
that some hard rows are active and some are not, a nonzero AL state on the
stacked limit, isolated joint-limit spikes that reach the terminal knot),
at B = 3 scenarios drawn from ``np.random.default_rng``, plus a FULL_SET
velocity limit and the stacked torque limits with a joint AL limit added
(soft limits on x and on u: not separable, so the generic path).  The JAX
functions run under ``jax.vmap``; each port function takes the JAX
function's inputs, so each comparison isolates one function.

Tolerances, as max |port - jax| / max |jax|: 1e-10 for the blocks, the
Schur assemblies and the exact solves (RHO = 1-10 keeps the regularized
Hessian blocks well conditioned; at 0.1-1 cyclic reduction already reads
1.6e-10, the two libraries' LU rounding).  1e-8 for 12 fixed PCG-SS
iterations: the JAX solve itself moves by up to 1.1e-9 when H is moved
by 1e-15 relative (measured on these systems), so its iterates carry
~1e-9 of rounding.  The condensed path against the generic one in the
port: the JAX test's 1e-7, and inactive hard multipliers exactly zero.
"""

import ctypes
import dataclasses
import functools
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajoptmpcreference_tpu import (
    ConstraintSet as JConstraintSet,
    URDFPlant as JURDFPlant,
    UrdfCost as JUrdfCost,
    make_sqp as jmake_sqp,
    serial_arm as jserial_arm,
)
from trajoptmpcreference_tpu_torch import convert
from trajoptmpcreference_tpu_torch import (
    ConstraintSet,
    URDFPlant,
    UrdfCost,
    make_sqp,
    serial_arm,
)
from trajoptmpcreference_tpu_torch.kernels import _build
from trajoptmpcreference_tpu_torch.ops import btridiag as TB
from trajoptmpcreference_tpu_torch.ops import fused_pcg as FP
from trajoptmpcreference_tpu_torch.solvers.kkt import KKTBlocks

B, N, DT = 3, 12, 0.05
NQ = 3
TOL, TOL_PCG = 1e-10, 1e-8
RHO = np.array([1.0, 3.0, 10.0])


def _rel(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _limits(cs, name):
    if name == "torque_as":
        return cs.with_torque_limits(0.5, -0.5, "ACTIVE_SET")
    if name == "torque_as_al":
        return (cs.with_torque_limits(0.5, -0.5, "ACTIVE_SET")
                .with_torque_limits(0.5, -0.5, "AUGMENTED_LAGRANGIAN"))
    if name == "joint_as":
        return cs.with_joint_limits(0.15, -0.15, "ACTIVE_SET")
    if name == "velocity_full":
        return cs.with_velocity_limits(0.3, -0.3, "FULL_SET")
    if name == "torque_as_al_joint_al":
        return (cs.with_torque_limits(0.5, -0.5, "ACTIVE_SET")
                .with_torque_limits(0.5, -0.5, "AUGMENTED_LAGRANGIAN")
                .with_joint_limits(0.15, -0.15, "AUGMENTED_LAGRANGIAN"))
    raise KeyError(name)


# name: path solve_schur takes
SETS = {"torque_as": "condensed", "torque_as_al": "condensed",
        "joint_as": "condensed", "velocity_full": "generic",
        "torque_as_al_joint_al": "generic"}


def _inputs(name, seed=7):
    rng = np.random.default_rng(seed)
    nx, nu = 2 * NQ, NQ
    X = 0.2 * rng.standard_normal((B, nx, N))
    X[:, :, 0] = 0.0          # x_0 interior to every box (see the JAX test)
    U = 0.6 * rng.standard_normal((B, nu, N - 1))
    if "joint" in name:
        # isolated joint-limit activations, the terminal knot included
        X = 0.02 * rng.standard_normal((B, nx, N))
        X[:, :, 0] = 0.0
        X[:, 0, 4], X[:, 1, 8], X[:, 0, N - 1] = 0.3, -0.3, 0.3
    return X, U


def _state(jcs, name):
    """The fresh state, or (stacked AL) one after outer rounds."""
    st = jcs.init_state(jnp.float64)
    if name in ("torque_as_al", "torque_as_al_joint_al"):
        st = tuple(s._replace(mu=10.0 * s.mu, lam=s.lam + 0.3) for s in st)
    return tuple(type(s)(*(jnp.broadcast_to(a, (B,) + a.shape) for a in s))
                 for s in st)


CONDENSED = sorted(n for n, path in SETS.items() if path == "condensed")
# FULL_SET's +-row pairs make its KKT system exactly singular (the
# reference's lstsq fallback), so its solves are not compared
SOLVES = [(n, solve) for n in sorted(SETS) if n != "velocity_full"
          for solve in ("thomas", "cr", "pcg", "pcg_kernel")]


@functools.lru_cache(maxsize=None)
def _system(name):
    jplant = JURDFPlant(robot=jserial_arm(NQ))
    f = jnp.float64
    jcost = JUrdfCost(jplant, jnp.eye(6, dtype=f), 100.0 * jnp.eye(6, dtype=f),
                      0.01 * jnp.eye(NQ, dtype=f),
                      jnp.asarray([1.5, 1.0, 0, 0, 0, 0], f))
    jcs = _limits(JConstraintSet(NQ, NQ, NQ, N), name)
    jkkt = jmake_sqp(jplant, jcost, jcs, N, DT, method="S").kkt
    t = lambda a: torch.as_tensor(np.array(a), dtype=torch.float64)
    plant = URDFPlant(robot=serial_arm(NQ))
    cost = UrdfCost(plant, torch.eye(6, dtype=torch.float64),
                    100.0 * torch.eye(6, dtype=torch.float64),
                    0.01 * torch.eye(NQ, dtype=torch.float64),
                    t([1.5, 1.0, 0, 0, 0, 0]))
    cs = _limits(ConstraintSet(NQ, NQ, NQ, N), name)
    assert convert.constraint_set_from_numpy(jcs) == cs
    kkt = make_sqp(plant, cost, cs, N, DT, method="S").kkt
    X, U = _inputs(name)
    jstate = _state(jcs, name)
    p = jcost.default_params
    jblocks = jax.jit(jax.vmap(lambda x, u, st: jkkt.form_blocks(
        x, u, x[:, 0], p, st)))(X, U, jstate)
    return dict(name=name, jkkt=jkkt, kkt=kkt, cost=cost, X=X, U=U,
                jstate=jstate, tstate=convert.soft_state_from_numpy(
                    jstate, device="cpu"), jblocks=jblocks,
                blocks=KKTBlocks(*(t(a) if a.dtype != bool
                                   else torch.as_tensor(np.array(a))
                                   for a in jblocks)), t=t)


@pytest.mark.parametrize("name", sorted(SETS))
def test_paths_are_the_jax_paths(name):
    system = _system(name)
    kkt, jkkt = system["kkt"], system["jkkt"]
    assert kkt.m == jkkt.m and kkt.bs == jkkt.bs
    assert kkt._can_split_schur() == jkkt._can_split_schur() is False
    assert kkt._can_condense_hard() == jkkt._can_condense_hard()
    assert kkt._can_condense_hard() == (SETS[system["name"]] == "condensed")


@pytest.mark.parametrize("name", sorted(SETS))
def test_form_blocks_matches_jax(name):
    s = _system(name)
    t = s["t"]
    X = t(s["X"])
    blocks = s["kkt"].form_blocks(X, t(s["U"]), X[..., 0],
                                  s["cost"].default_params, s["tstate"])
    for field in KKTBlocks._fields:
        a, b = getattr(blocks, field), getattr(s["jblocks"], field)
        if field == "hact":
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            assert _rel(a, b) < TOL, field
    if s["name"] != "velocity_full":
        act = blocks.hact.numpy()
        assert 0 < act.sum() < act.size            # mixed activity
    if s["name"] == "joint_as":
        assert act[:, -1].sum() > 0                # the terminal group too


@pytest.mark.parametrize("name", sorted(SETS))
def test_generic_schur_blocks_match_jax(name):
    s = _system(name)
    ref = jax.jit(jax.vmap(s["jkkt"].schur_blocks))(s["jblocks"], RHO)
    S, gam, invG, E, F = s["kkt"].schur_blocks(s["blocks"], torch.tensor(RHO))
    jS, jgam, jinvG, jE, jF = ref
    for name, a, b in (("diag", S.diag, jS.diag), ("upper", S.upper, jS.upper),
                       ("gam", gam, jgam), ("invG", invG, jinvG),
                       ("E", E, jE), ("F", F, jF)):
        assert _rel(a, b) < TOL, name


@pytest.mark.parametrize("name", CONDENSED)
def test_condensed_schur_blocks_match_jax(name):
    s = _system(name)
    jS, jgam, jaux = jax.jit(jax.vmap(s["jkkt"]._schur_blocks_condensed))(
        s["jblocks"], RHO)
    S, gam, aux = s["kkt"]._schur_blocks_condensed(s["blocks"],
                                                   torch.tensor(RHO))
    assert S.bs == 2 * NQ
    for name, a, b in (("diag", S.diag, jS.diag), ("upper", S.upper, jS.upper),
                       ("gam", gam, jgam)):
        assert _rel(a, b) < TOL, name
    for i, (a, b) in enumerate(zip(aux, jaux)):
        assert _rel(a, b) < TOL, i


@pytest.mark.parametrize("name,solve", SOLVES)
def test_solve_schur_matches_jax(name, solve):
    """Each path's solve (exact, or PCG-SS for 12 fixed iterations from a
    warm start; pcg_kernel is the fused PCG, its plain version here)
    against JAX's solve_schur on the same blocks."""
    s = _system(name)
    kkt, jkkt = s["kkt"], s["jkkt"]
    rng = np.random.default_rng(11)
    guess = 0.1 * rng.standard_normal((B, N, kkt.bs))
    pcg_kw = dict(use_pcg=True, pcg_tol=0.0, pcg_max_iter=12, precond="SS")
    if solve in ("thomas", "cr"):
        jkkt = dataclasses.replace(jkkt, exact_schur=solve)
        kkt = dataclasses.replace(kkt, exact_schur=solve)
        jfn = lambda b, r, g: jkkt.solve_schur(b, r)
        kw = {}
    else:
        jfn = lambda b, r, g: jkkt.solve_schur(b, r, guess=g, **pcg_kw)
        kw = dict(pcg_kw, guess=torch.tensor(guess))
        if solve == "pcg_kernel":
            # the fused PCG: K4's plain version against the Pallas kernel
            # in interpret mode (both read the symmetric blocks packed)
            kkt = dataclasses.replace(kkt, use_kernel_pcg=True)
            jkkt = dataclasses.replace(jkkt, use_pallas_pcg=True)
    jdxu, jlam, _ = jax.jit(jax.vmap(jfn))(s["jblocks"], RHO, guess)
    dxu, lam, stats = kkt.solve_schur(s["blocks"], torch.tensor(RHO), **kw)
    assert lam.shape == (B, N, kkt.bs)            # [defect; hard] on every path
    tol = TOL_PCG if solve.startswith("pcg") else TOL
    assert _rel(dxu, jdxu) < tol and _rel(lam, jlam) < tol
    if solve.startswith("pcg"):
        assert stats.pcg_iters.tolist() == [12] * B


@pytest.mark.parametrize("name", CONDENSED)
def test_condensed_operator_matches_generic(name):
    """The condensed path solves the generic path's KKT system (the JAX
    test_condensed_schur_matches_generic, in the port): multipliers and
    steps to 1e-7, inactive hard multipliers exactly zero, and PCG on the
    condensed core to a small relative residual."""
    s = _system(name)
    kkt, blocks = s["kkt"], s["blocks"]
    rho = torch.full((B,), 1e-3, dtype=torch.float64)
    Sg, gamg, invG, E, F = kkt.schur_blocks(blocks, rho)
    lam_g = TB.btd_block_thomas(Sg, gamg)
    dxu_g = kkt.recover_dxu(invG, E, F, blocks, lam_g)
    dxu_c, lam_c, _ = kkt.solve_schur(blocks, rho)
    np.testing.assert_allclose(lam_c.numpy(), lam_g.numpy(), rtol=1e-7,
                               atol=1e-8)
    np.testing.assert_allclose(dxu_c.numpy(), dxu_g.numpy(), rtol=1e-7,
                               atol=1e-8)
    lam_h = lam_c[..., kkt.nx:]
    assert bool((lam_h[~blocks.hact] == 0.0).all())
    Sc, gamc, _ = kkt._schur_blocks_condensed(blocks, rho)
    _, lam_p, _ = kkt.solve_schur(blocks, rho, use_pcg=True, pcg_tol=1e-12,
                                  pcg_max_iter=400, precond="SS")
    res = TB.btd_matvec(Sc, lam_p[..., :kkt.nx]) - gamc
    rel = res.flatten(1).norm(dim=1) / gamc.flatten(1).norm(dim=1)
    assert float(rel.max()) < 1e-4


def test_kernel_pcg_sizes_on_the_generic_path(tmp_path):
    """K4 on the generic path's block size: the flagship's six torques as
    hard rows there make bs = 12 + 12 = 24, which K4's cluster variant
    holds in one block up to N = 45 in f32 and N = 22 in f64 (its size
    formula, from a g++ build of pcg.cu), bs = 18 up to 78 / 38 and bs =
    30 up to 29 / 14; one block row more, and the flagship's N = 64 at bs
    = 24 and 30, take a cluster of more blocks per scenario (the operator
    spread over their shared memory), and check_fits raises at none of
    them; the condensed core (bs = 12) takes the register variant."""
    so = tmp_path / "libpcg.so"
    subprocess.run(["g++", "-x", "c++", "-std=c++17", "-O1", "-shared",
                    "-fPIC", "-o", str(so), str(_build.CSRC / "pcg.cu")],
                   check=True)
    lib = ctypes.CDLL(str(so))
    _build.bind_pcg_shapes(lib)
    elems, var = lib.tmr_pcg_smem_elems, lib.tmr_pcg_variant
    size = lib.tmr_pcg_cluster_size
    for bs, dtype, n_max in ((24, torch.float32, 45), (24, torch.float64, 22),
                             (18, torch.float32, 78), (18, torch.float64, 38),
                             (30, torch.float32, 29), (30, torch.float64, 14)):
        FP.check_fits(n_max, bs, dtype, elems)
        assert FP.variant(n_max, bs, dtype, var) == 3
        assert FP.cluster_size(n_max, bs, dtype, size) == 1
        for n in {n_max + 1, max(n_max + 1, 64)}:
            FP.check_fits(n, bs, dtype, elems)
            assert FP.variant(n, bs, dtype, var) == 3, (bs, dtype, n)
            assert FP.cluster_size(n, bs, dtype, size) >= 2, (bs, dtype, n)
    for dtype in (torch.float32, torch.float64):
        FP.check_fits(64, 12, dtype, elems)
        assert FP.variant(64, 12, dtype, var) == 0
