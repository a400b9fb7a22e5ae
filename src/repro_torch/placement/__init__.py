"""Data/replica placement: locality-derived eligible sets as runtime state.

The port's copy of ``repro/placement``.  A task group's available-server
set **is** its replica placement; this package makes placement
first-class, mutable state instead of trace-time constants:

- :class:`PlacementStore` — blocks (data blocks, model checkpoints,
  LoRA adapters) → server replica sets, with an event API
  (``add_replica`` / ``evict`` / ``server_join`` / ``server_leave`` /
  ``rebalance``) and a ``version`` counter;
- :mod:`~repro_torch.placement.policies` — pluggable re-replication
  (``static``, access-driven ``hot-block``, manifest-driven
  ``checkpoint``);
- :class:`PlacedJob` + :class:`PlacementEvent` — the runtime surface:
  traces build jobs whose groups reference block IDs, the engine
  re-resolves them at arrival and applies placement churn next to fault
  events (a deleted replica strands queued fragments exactly like a
  server failure);
- :mod:`~repro_torch.placement.checkpoint` — serve-layer blocks derived
  from :mod:`repro_torch.checkpoint.store` manifests, so
  :class:`repro_torch.serve.engine.ReplicaRouter` resolves eligible
  replicas by model / adapter ID.
"""

from .checkpoint import (
    CheckpointInfo,
    CheckpointManifestPolicy,
    register_checkpoint,
    scan_checkpoints,
)
from .events import PlacementEvent, churn_timeline
from .policies import (
    REPLICATION_POLICIES,
    HotBlockPolicy,
    ReplicationPolicy,
    StaticPolicy,
    list_replication_policies,
    make_replication_policy,
)
from .store import (
    PlacedJob,
    PlacementDelta,
    PlacementStore,
    data_block,
    lora_block,
    model_block,
    zipf_servers,
    zipf_weights,
)

__all__ = [
    "CheckpointInfo",
    "CheckpointManifestPolicy",
    "HotBlockPolicy",
    "PlacedJob",
    "PlacementDelta",
    "PlacementEvent",
    "PlacementStore",
    "REPLICATION_POLICIES",
    "ReplicationPolicy",
    "StaticPolicy",
    "churn_timeline",
    "data_block",
    "list_replication_policies",
    "lora_block",
    "make_replication_policy",
    "model_block",
    "register_checkpoint",
    "scan_checkpoints",
    "zipf_servers",
    "zipf_weights",
]
