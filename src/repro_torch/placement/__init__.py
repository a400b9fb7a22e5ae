"""Data/replica placement: locality-derived eligible sets as runtime state.

The port's copy of ``repro/placement``.  A task group's available-server
set **is** its replica placement; this package makes placement
first-class, mutable state instead of trace-time constants:

- :class:`PlacementStore` — blocks (data blocks, model checkpoints,
  LoRA adapters) → server replica sets, with an event API
  (``add_replica`` / ``evict`` / ``server_join`` / ``server_leave`` /
  ``rebalance``) and a ``version`` counter;
- :mod:`~repro_torch.placement.policies` — pluggable re-replication
  (``static``, access-driven ``hot-block``);
- :class:`PlacedJob` + :class:`PlacementEvent` — the runtime surface:
  traces build jobs whose groups reference block IDs, the engine
  re-resolves them at arrival and applies placement churn next to fault
  events (a deleted replica strands queued fragments exactly like a
  server failure).

The reference's ``placement/checkpoint.py`` (serve-layer blocks derived
from checkpoint manifests, and the ``checkpoint`` replication policy)
reads manifests through its checkpoint store, so it waits for the
port's checkpoint slice; :class:`repro_torch.serve.engine.ReplicaRouter`
already routes by model / adapter ID through :func:`model_block` /
:func:`lora_block` blocks registered by hand.
"""

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
    "zipf_servers",
    "zipf_weights",
]
