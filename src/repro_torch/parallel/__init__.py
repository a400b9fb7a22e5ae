"""Distribution: sharding rules, the ambient mesh, state placement.

The port's counterpart of ``repro/parallel`` on ``torch.distributed``
(``DeviceMesh``, ``DTensor``).  The reference's ``compat.py`` (a shim
over jax versions) has no counterpart; its ``set_mesh`` lives in
:mod:`.constrain`.
"""

from .constrain import ambient_mesh, logical_spec, set_mesh, shard, split_batch
from .sharding import (
    AbstractMesh,
    batch_sharding,
    cache_sharding,
    fsdp_axes,
    gather_state,
    param_sharding,
    placements,
    replicated,
    serve_param_sharding,
    shard_state,
)

__all__ = [
    "AbstractMesh",
    "ambient_mesh",
    "batch_sharding",
    "cache_sharding",
    "fsdp_axes",
    "gather_state",
    "logical_spec",
    "param_sharding",
    "placements",
    "replicated",
    "serve_param_sharding",
    "set_mesh",
    "shard",
    "shard_state",
    "split_batch",
]
