"""The ranks of the port's parallel-layer tests, on gloo.

    python tests/torch_parallel_worker.py CASE NPROCS DIR

starts NPROCS processes (torch.multiprocessing.spawn); each joins one gloo
group through the file store DIR/store, runs CASE ("horizon" or "sqp") on
the numpy inputs DIR/inputs.npz, and writes its results to
DIR/rank<r>.npz.  The processes import torch and the port only; the
tests (tests/test_torch_parallel_*.py) start them through ``spawn`` and
compare what they write with the JAX package.  Replicated results are
written by every rank, so a test can hold them bit-equal across ranks.
"""

import os
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

f64 = torch.float64


def spawn(case, P, d, inputs, timeout=900):
    """Run ``case`` on P gloo ranks in a child process; every rank's
    results (d: a pathlib directory of the caller's)."""
    np.savez(d / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), case,
                           str(P), str(d)], env=env, capture_output=True,
                          text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(P)]


def _horizon(rank, P, inp):
    """Every horizon-sharded operator on the random SPD systems: matvec,
    PCG for each preconditioner (batched, and each scenario alone), the
    SPIKE exact solve in f64 and f32, and the two all-gather forms."""
    from trajoptmpcreference_tpu_torch.ops.btridiag import BlockTridiag
    from trajoptmpcreference_tpu_torch.parallel import (
        make_mesh,
        shard_btd,
        sharded_btd_matvec,
        sharded_pcg,
    )
    from trajoptmpcreference_tpu_torch.parallel.horizon import sharded_btd_exact
    from trajoptmpcreference_tpu_torch.parallel.multihost import all_gather_tiled

    mesh = make_mesh((P,), ("horizon",), device_type="cpu")
    group = mesh.get_group("horizon")
    out = {}

    def local(diag, upper, b, dtype=f64):
        A = BlockTridiag(torch.tensor(diag, dtype=dtype),
                         torch.tensor(upper, dtype=dtype))
        L = A.nblocks // P
        b = torch.tensor(b, dtype=dtype)[:, rank * L:(rank + 1) * L]
        return shard_btd(A, P).local(rank, P), b

    gather = lambda x: all_gather_tiled(x, group, dim=1).numpy()
    A, x = local(inp["diag"], inp["upper"], inp["x"])
    y = sharded_btd_matvec(A, x, group)
    out["matvec"] = gather(y)
    # the list form of all_gather, concatenated along the horizon
    parts = [torch.empty_like(y) for _ in range(P)]
    dist.all_gather(parts, y, group=group)
    out["matvec_list"] = torch.cat(parts, dim=1).numpy()

    A, b = local(inp["diag"], inp["upper"], inp["b"])
    for pre in ("0", "J", "BJ", "SS"):
        kw = dict(precond=pre, exit_tolerance=1e-10, max_iter=200)
        res = sharded_pcg(A, b, group, **kw)
        out[f"pcg_{pre}"] = gather(res.x)
        out[f"pcg_{pre}_iters"] = res.iters.numpy()
        out[f"pcg_{pre}_converged"] = res.converged.numpy()
        # each scenario alone: the freeze keeps a finished one unchanged
        alone = [sharded_pcg(type(A)(*(t[i:i + 1] for t in A)), b[i:i + 1],
                             group, **kw) for i in range(b.shape[0])]
        out[f"pcg_{pre}_alone"] = np.concatenate([gather(r.x) for r in alone])
        out[f"pcg_{pre}_alone_iters"] = np.concatenate(
            [r.iters.numpy() for r in alone])

    for tag, dtype in (("f64", f64), ("f32", torch.float32)):
        A, b = local(inp["exact_diag"], inp["exact_upper"], inp["exact_b"],
                     dtype)
        out[f"exact_{tag}"] = gather(sharded_btd_exact(A, b, group))
    return out


def _arm2(N, options, cset=None, **kw):
    """(unsharded solver, cost, a maker of the sharded one) for the
    tests/test_parallel.py arm2 reach."""
    from trajoptmpcreference_tpu_torch import (
        SQPOptions,
        URDFPlant,
        UrdfCost,
        make_sqp,
        serial_arm,
    )
    plant = URDFPlant(robot=serial_arm(2))
    cost = UrdfCost(plant, torch.eye(4, dtype=f64), 100.0 * torch.eye(4, dtype=f64),
                    0.1 * torch.eye(2, dtype=f64),
                    torch.tensor([0.5, 1.5, 0.0, 0.0], dtype=f64))
    opts = SQPOptions(**options)
    build = lambda **m: make_sqp(plant, cost, cset, N, 0.05, options=opts,
                                 **kw, **m)
    return build(), cost, build


def _solve_pair(out, key, base, sharded, x0, u0, params, rank):
    """Write the sharded solve's results (every rank) and the unsharded
    one's (rank 0)."""
    res = sharded.solve(x0, u0, params)
    for field in ("U", "X", "exit_sqp", "sqp_iters", "lam"):
        out[f"{key}_{field}"] = getattr(res, field).numpy()
    if rank == 0:
        ref = base.solve(x0, u0, params)
        for field in ("U", "X", "exit_sqp", "sqp_iters"):
            out[f"{key}_base_{field}"] = getattr(ref, field).numpy()


def _errors(P, mesh, build):
    """The messages of make_sqp's and the mesh helpers' errors."""
    from trajoptmpcreference_tpu_torch.parallel import (
        global_mesh,
        make_mesh,
        process_local_batch,
    )
    msgs = {}

    def catch(key, fn):
        try:
            fn()
        except ValueError as e:
            msgs[key] = str(e)

    catch("method_N", lambda: build(method="N", mesh=mesh))
    catch("N_divisible", lambda: build(method="PCG-SS", mesh=mesh, N=12))
    catch("local_rows", lambda: build(method="S", mesh=mesh, N=16))
    catch("global_mesh", lambda: global_mesh(("batch", "horizon"), 3,
                                             device_type="cpu"))
    catch("make_mesh_more", lambda: make_mesh((2 * P,), device_type="cpu"))
    catch("make_mesh_fewer", lambda: make_mesh((P // 2,), device_type="cpu"))
    catch("local_batch", lambda: process_local_batch(P + 1))
    return {f"error_{k}": np.array(v) for k, v in msgs.items()}


def _sqp(rank, P, inp):
    """P = 8: PCG-SS at N = 16 and method S at N = 32 horizon-sharded,
    shard_solve of the pendulum batch, every error.  P = 4: the
    ACTIVE_SET PCG-SS solve and the flagship's cold solve (6-DoF arm, N =
    64, f64, B = 2) by method S."""
    from trajoptmpcreference_tpu_torch import (
        ConstraintSet,
        PendulumPlant,
        QuadraticCost,
        make_sqp,
    )
    from trajoptmpcreference_tpu_torch.parallel import (
        global_mesh,
        make_mesh,
        process_local_batch,
        shard_solve,
    )
    out = {}
    hmesh = make_mesh((P,), ("horizon",), device_type="cpu")
    x0 = torch.tensor(inp["arm_x0"])
    N = x0.shape[-1]
    u0 = torch.zeros((x0.shape[0], 2, N - 1), dtype=f64)
    tol = dict(expected_reduction_min=-100.0, exit_tolerance_linSys=1e-10)
    if P == 8:
        base, cost, build = _arm2(N, dict(tol, max_iter=12, max_iter_linSys=60),
                                  method="PCG-SS")
        _solve_pair(out, "pcg_ss", base, build(mesh=hmesh), x0, u0,
                    cost.default_params, rank)
        x32 = torch.zeros((1, 4, 32), dtype=f64)
        base, cost, build = _arm2(32, dict(expected_reduction_min=-100.0,
                                           max_iter=12), method="S")
        _solve_pair(out, "exact", base, build(mesh=hmesh), x32,
                    torch.zeros((1, 2, 31), dtype=f64), cost.default_params,
                    rank)
        out.update(_errors(P, hmesh, lambda **kw: _arm2(
            kw.pop("N", 32), dict(expected_reduction_min=-100.0))[2](**kw)))

        # shard_solve over a 'batch' dim (tests/test_parallel.py:95-116)
        bmesh = global_mesh(("batch",), device_type="cpu")
        t = lambda a: torch.tensor(np.asarray(a), dtype=f64)
        pcost = QuadraticCost(t(np.eye(2)), t(50.0 * np.eye(2)), t(0.1 * np.eye(1)),
                              t([np.pi, 0.0]))
        psolver = make_sqp(PendulumPlant(), pcost, None, 12, 0.1, method="S")
        cps = pcost.default_params._replace(xg=t(inp["pend_goals"]))
        x0s, u0s = t(inp["pend_x0s"]), torch.zeros((16, 1, 11), dtype=f64)
        res = shard_solve(psolver, bmesh)(x0s, u0s, cps)
        out["shard_U"], out["shard_exit"] = res.U.numpy(), res.exit_sqp.numpy()
        sl = process_local_batch(16)
        out["local_batch"] = np.array([sl.start, sl.stop])
        if rank == 0:
            out["shard_base_U"] = psolver.solve(x0s, u0s, cps).U.numpy()
    else:
        cset = ConstraintSet(2, 2, 2, N).with_torque_limits(
            0.5, -0.5, "ACTIVE_SET")
        base, cost, build = _arm2(N, dict(tol, max_iter=10, max_iter_linSys=80),
                                  cset=cset, method="PCG-SS")
        _solve_pair(out, "active_set", base, build(mesh=hmesh), x0, u0,
                    cost.default_params, rank)
        # the flagship's cold solve, method S, horizon-sharded
        from trajoptmpcreference_tpu_torch import flagship as F
        x0f = torch.tensor(inp["flag_x0s"])
        goals = torch.tensor(inp["flag_goals"])
        X0 = x0f[..., None].expand(-1, 12, 64).contiguous()
        U0 = torch.zeros((x0f.shape[0], 6, 63), dtype=f64)
        plant, fcost, base = F.flagship(N=64, dtype=f64, device="cpu")
        sharded = make_sqp(plant, fcost, None, 64, base.dt, method="S",
                           options=base.options, mesh=hmesh)
        params = fcost.default_params._replace(xg=goals)
        _solve_pair(out, "flagship", base, sharded, X0, U0, params, rank)
        if rank == 0:
            thomas = F.flagship(N=64, dtype=f64, device="cpu",
                                exact_schur="thomas")[2]
            out["flagship_thomas_U"] = thomas.solve(X0, U0, params).U.numpy()
    return out


def _worker(rank, case, P, d):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d}/store",
                            world_size=P, rank=rank)
    try:
        inp = dict(np.load(os.path.join(d, "inputs.npz")))
        out = {"horizon": _horizon, "sqp": _sqp}[case](rank, P, inp)
        np.savez(os.path.join(d, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    case, nprocs, d = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    torch.multiprocessing.spawn(_worker, args=(case, nprocs, d), nprocs=nprocs)
