"""Distributed execution layer over ``torch.distributed``: scenario
splits and horizon sharding.

Port of trajoptmpcreference_tpu/parallel (its mesh axes become the named
dims of a ``torch.distributed.device_mesh.DeviceMesh``, one process group
each):

  * batch (DP analogue): the explicit scenario batch on one card;
    ``shard_solve`` splits it over the mesh's 'batch' dim;
  * horizon (TP/SP analogue): the Schur solve, by PCG or by the SPIKE
    exact solve, sharded over the 'horizon' dim with halo exchanges
    (``batch_isend_irecv``) and all-reduced dot products.

The layer runs on the card (NCCL) unless the caller asks for
``device_type="cpu"`` (gloo).
"""

from trajoptmpcreference_tpu_torch.parallel.batch import (
    batch_solve,
    make_mesh,
    shard_solve,
)
from trajoptmpcreference_tpu_torch.parallel.horizon import (
    ShardedBTD,
    shard_btd,
    sharded_btd_matvec,
    sharded_pcg,
    sharded_schur_solve,
)
from trajoptmpcreference_tpu_torch.parallel.multihost import (
    global_mesh,
    initialize,
    process_local_batch,
)

__all__ = [
    "batch_solve",
    "make_mesh",
    "shard_solve",
    "sharded_btd_matvec",
    "sharded_pcg",
    "sharded_schur_solve",
    "global_mesh",
    "initialize",
    "process_local_batch",
    "ShardedBTD",
    "shard_btd",
]
