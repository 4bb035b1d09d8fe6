"""Multi-process orchestration: one process per card, one process group.

Port of trajoptmpcreference_tpu/parallel/multihost.py.  The scale path is:
``initialize()`` in every process (``torchrun --nproc_per_node=P`` sets
its rendezvous) -> one ``global_mesh`` over every rank -> ``shard_solve``
/ the horizon-sharded solvers, exactly as within one process (they see
only the mesh's named dims and their process groups; NCCL carries the
collectives between cards, gloo between CPU processes).

A single-process run works unchanged: ``initialize()`` does nothing when
no coordinator is configured, as ``jax.distributed.initialize``'s wrapper
does there.
"""

from __future__ import annotations

import collections
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
# the collectives the layer has issued, by kind ("all_gather",
# "all_reduce", "p2p": one per batch_isend_irecv)
CALLS: collections.Counter = collections.Counter()


def _check_device_type(device_type: str) -> None:
    """The layer runs on the card unless the caller asks for the CPU."""
    if device_type not in BACKENDS:
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got "
                         f"{device_type!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device_type='cpu' to run the "
            "parallel layer on gloo")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               init_method: Optional[str] = None,
               device_type: str = "cuda") -> None:
    """``torch.distributed.init_process_group`` with environment fallbacks;
    nothing happens in a single process.

    The rendezvous is ``init_method`` when given (``tcp://host:port`` or
    ``file:///path``), else ``tcp://`` + ``coordinator_address`` or
    ``TMR_COORDINATOR`` (host:port), else torchrun's ``MASTER_ADDR`` /
    ``MASTER_PORT`` (``env://``).  ``num_processes`` / ``process_id``
    default to ``WORLD_SIZE`` / ``RANK``.  The backend is NCCL on
    ``"cuda"`` (each rank first takes the card of its ``LOCAL_RANK``, or
    its rank modulo the cards) and gloo on ``"cpu"``."""
    _check_device_type(device_type)
    coordinator_address = coordinator_address or os.environ.get(
        "TMR_COORDINATOR")
    if init_method is None:
        if coordinator_address is not None:
            init_method = f"tcp://{coordinator_address}"
        elif "MASTER_ADDR" in os.environ:
            init_method = "env://"
    if init_method is None and num_processes is None:
        return                      # single process
    if num_processes is None:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None:
        process_id = int(os.environ["RANK"])
    kw = {}
    if device_type == "cuda":
        local = int(os.environ.get("LOCAL_RANK",
                                   process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        kw["device_id"] = torch.device("cuda", local)
    dist.init_process_group(BACKENDS[device_type], init_method=init_method,
                            world_size=num_processes, rank=process_id, **kw)


def _require_group() -> int:
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call parallel.initialize() (or "
            "torch.distributed.init_process_group) first")
    return dist.get_world_size()


def global_mesh(axis_names: Sequence[str] = ("batch",),
                horizon_axis: int = 1, device_type: str = "cuda"):
    """A ``DeviceMesh`` over every rank of the job.

    With two axis names the horizon dim gets ``horizon_axis`` ranks (keep
    them on one host, where NVLink carries the halo exchanges) and the
    batch dim the rest."""
    from torch.distributed.device_mesh import DeviceMesh
    _check_device_type(device_type)
    n = _require_group()
    ranks = torch.arange(n)
    if len(axis_names) == 1:
        return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axis_names))
    if n % horizon_axis:
        raise ValueError(f"{n} devices not divisible by horizon={horizon_axis}")
    return DeviceMesh(device_type, ranks.reshape(n // horizon_axis, horizon_axis),
                      mesh_dim_names=tuple(axis_names))


def process_local_batch(global_batch: int) -> slice:
    """The slice of a globally sharded batch this rank feeds."""
    p = dist.get_rank() if dist.is_initialized() else 0
    np_ = dist.get_world_size() if dist.is_initialized() else 1
    if global_batch % np_:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{np_} processes")
    per = global_batch // np_
    return slice(p * per, (p + 1) * per)


def all_gather_tiled(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (JAX's
    ``all_gather(tiled=True)``), by one collective on ``group``.  Bool
    tensors travel as uint8."""
    P = dist.get_world_size(group)
    src = x.movedim(dim, 0)
    wire = src.to(torch.uint8) if src.dtype == torch.bool else src
    out = wire.new_empty((P * wire.shape[0],) + tuple(wire.shape[1:]))
    # all_gather_single is the name newer releases keep
    gather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    gather(out, wire.contiguous(), group=group)
    CALLS["all_gather"] += 1
    return out.to(x.dtype).movedim(0, dim)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``x`` (JAX's ``psum``), on every rank, by
    one collective on ``group``; ``x`` is left as it was."""
    out = x.clone()
    dist.all_reduce(out, group=group)
    CALLS["all_reduce"] += 1
    return out
