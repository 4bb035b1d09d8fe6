"""Scenario batching: the explicit batch within a card, a split of it
across the mesh.

Port of trajoptmpcreference_tpu/parallel/batch.py.  The port's solvers
already take the scenario batch as their leading axis, so ``batch_solve``
is the solver itself (JAX's vmap).  ``shard_solve`` gives each rank of a
mesh dim its B / P scenarios, solves them locally, and hands every rank
the global result through one all-gather per output on that dim's
process group:

    solve_b = batch_solve(solver)          # (B, ...) on one card
    solve_s = shard_solve(solver, mesh)    # split over mesh dim 'batch'
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.distributed as dist

from trajoptmpcreference_tpu_torch.parallel.multihost import (
    _check_device_type,
    _require_group,
    all_gather_tiled,
)


def make_mesh(axis_sizes: Sequence[int],
              axis_names: Sequence[str] = ("batch",),
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of shape ``axis_sizes`` over the job's ranks
    (row-major), which it must cover: a rank outside the mesh would have
    no part in its collectives.  ``device_type`` is the card unless the
    caller asks for ``"cpu"`` (gloo)."""
    from torch.distributed.device_mesh import DeviceMesh
    _check_device_type(device_type)
    have = _require_group()
    n = 1
    for s in axis_sizes:
        n *= int(s)
    if n > have:
        raise ValueError(f"mesh needs {n} devices, have {have}")
    if n < have:
        raise ValueError(f"a mesh of {n} devices leaves {have - n} of the "
                         f"{have} ranks outside it")
    return DeviceMesh(device_type, torch.arange(n).reshape(tuple(axis_sizes)),
                      mesh_dim_names=tuple(axis_names))


def axis_size(mesh, axis: str) -> int:
    """The number of ranks along the named dim of ``mesh``."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def batch_solve(solver, cost_params_batched: bool = True):
    """The solver's ``solve`` over a leading scenario axis: the port's
    solvers take it already.  Returns fn(X0s (B, nx, N), U0s (B, nu, N-1)
    [, cost_params with xg (B, d)])."""
    if cost_params_batched:
        return lambda x0, u0, cp: solver.solve(x0, u0, cost_params=cp)
    return lambda x0, u0: solver.solve(x0, u0)


def _tree_map(fn, tree):
    """``fn`` on every tensor of nested tuples / NamedTuples."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple):
        items = [_tree_map(fn, t) for t in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


def shard_batch(arrs: Any, mesh, axis: str = "batch"):
    """This rank's slice, along the leading axis, of every tensor in
    ``arrs`` (nested tuples of tensors): the scatter, made once.  The
    batch must divide by the size of ``axis``."""
    P = axis_size(mesh, axis)
    p = dist.get_rank(mesh.get_group(axis))

    def local(a):
        if a.shape[0] % P:
            raise ValueError(f"batch {a.shape[0]} must divide by the "
                             f"{axis!r} axis size {P}")
        per = a.shape[0] // P
        return a[p * per:(p + 1) * per].contiguous()

    return _tree_map(local, arrs)


def shard_solve(solver, mesh, axis: str = "batch",
                cost_params_batched: bool = True):
    """Split the scenario batch over ``axis`` of ``mesh``: each rank solves
    its B / P scenarios, and every tensor of the result is all-gathered
    back to the global batch on every rank.  Per-scenario cost parameters
    are the (B, d) goals ``cost_params.xg`` (a (d,) goal is every
    scenario's); the other fields are shared."""
    group = mesh.get_group(axis)
    vsolve = batch_solve(solver, cost_params_batched)
    gather = lambda res: _tree_map(lambda t: all_gather_tiled(t, group), res)

    if cost_params_batched:
        def fn(x0s, u0s, cps):
            if cps.xg.dim() < 2:        # one goal for every scenario
                return gather(vsolve(*shard_batch((x0s, u0s), mesh, axis), cps))
            x0, u0, xg = shard_batch((x0s, u0s, cps.xg), mesh, axis)
            return gather(vsolve(x0, u0, cps._replace(xg=xg)))
    else:
        def fn(x0s, u0s):
            return gather(vsolve(*shard_batch((x0s, u0s), mesh, axis)))
    return fn
