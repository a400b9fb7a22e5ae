"""Pluggable replication policies: how a placement store re-replicates.

The port's copy of ``repro/placement/policies.py``.  A policy is a pure
*proposer*: given the store's current state and an rng,
:meth:`rebalance` returns a
:class:`~repro_torch.placement.store.PlacementDelta` of (block, server)
adds/evicts without mutating anything.
The store (standalone use) or the scheduling engine (which must strand
queued work on evictions) applies the delta.

Registered policies:

- ``static``    — placement is decided when a block is registered
  (the paper's Zipf model at trace seeding) and never changes; every
  rebalance proposes the empty delta.  This is the backend that must
  reproduce the pre-placement-store schedules bit-identically.
- ``hot-block`` — access-count-driven re-replication: the hottest
  blocks gain replicas on the least-loaded active servers (up to
  ``max_replicas``), the coldest shed replicas from their most-loaded
  holders (never below ``min_replicas``) — task replication as a
  scheduling lever (Wang–Joshi–Wornell, arXiv:1404.1328).
- ``checkpoint`` — manifest-derived: registered by
  :mod:`repro_torch.placement.checkpoint`, which reads checkpoint
  manifests, as the reference's ``repro/placement/checkpoint.py``.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Protocol, runtime_checkable

import numpy as np

from .store import PlacementDelta

if TYPE_CHECKING:  # pragma: no cover
    from .store import PlacementStore

__all__ = [
    "ReplicationPolicy",
    "StaticPolicy",
    "HotBlockPolicy",
    "REPLICATION_POLICIES",
    "make_replication_policy",
    "list_replication_policies",
]


@runtime_checkable
class ReplicationPolicy(Protocol):
    """What the store requires of a replication policy."""

    name: str

    def rebalance(
        self, store: "PlacementStore", rng: np.random.Generator
    ) -> PlacementDelta:
        """Propose replica adds/evicts for the store's current state."""
        ...


@dataclasses.dataclass(frozen=True)
class StaticPolicy:
    """Frozen placement: rebalances are always empty (today's behavior)."""

    name: str = "static"

    def rebalance(self, store, rng) -> PlacementDelta:
        return PlacementDelta()


def _least_loaded(
    load: dict[int, int], exclude: set[int]
) -> int | None:
    """Deterministic least-loaded active server outside ``exclude``
    (ties broken by server id)."""
    candidates = [m for m in load if m not in exclude]
    if not candidates:
        return None
    return min(candidates, key=lambda m: (load[m], m))


@dataclasses.dataclass(frozen=True)
class HotBlockPolicy:
    """Repair + access-driven re-replication with per-rebalance budgets.

    Each rebalance runs two passes:

    1. **repair** — every block that has fallen below ``min_replicas``
       (but still has ≥ 1 replica to copy from) is topped back up on the
       least-loaded active servers; this is what protects availability
       under replica-eviction churn (the HDFS-style re-replication
       queue);
    2. **hot adds** — up to ``add_budget`` of the hottest blocks
       (non-zero access count, below ``max_replicas``) gain one replica
       each; optionally ``evict_budget`` coldest blocks above
       ``min_replicas`` shed one from their most-loaded holder.

    Entirely deterministic given the store state (ties broken by block
    name / server id); the rng is part of the policy interface but
    unused here.
    """

    name: str = "hot-block"
    max_replicas: int = 3
    min_replicas: int = 1
    add_budget: int = 4
    evict_budget: int = 0  # off by default: adds only

    def rebalance(self, store, rng) -> PlacementDelta:
        load = store.server_load()
        blocks = store.blocks()
        added: list[tuple[str, int]] = []
        evicted: list[tuple[str, int]] = []

        for block in blocks:  # repair pass (not counted against budgets)
            reps = set(store.replicas(block))
            while 0 < len(reps) < self.min_replicas:
                target = _least_loaded(load, reps)
                if target is None:
                    break
                reps.add(target)
                load[target] += 1
                added.append((block, target))

        hot = sorted(blocks, key=lambda b: (-store.access_count(b), b))
        budget = self.add_budget
        for block in hot:
            if budget <= 0 or store.access_count(block) == 0:
                break
            reps = set(store.replicas(block)) | {
                m for b, m in added if b == block
            }
            if len(reps) >= self.max_replicas:
                continue
            target = _least_loaded(load, reps)
            if target is None:
                continue
            added.append((block, target))
            load[target] += 1
            budget -= 1

        if self.evict_budget > 0:
            cold = sorted(blocks, key=lambda b: (store.access_count(b), b))
            just_added = {b for b, _ in added}
            for block in cold:
                if len(evicted) >= self.evict_budget:
                    break
                if block in just_added:
                    continue
                reps = store.replicas(block)
                if len(reps) <= self.min_replicas:
                    continue
                victim = max(reps, key=lambda m: (load.get(m, 0), m))
                evicted.append((block, victim))
                if victim in load:
                    load[victim] -= 1

        return PlacementDelta(tuple(added), tuple(evicted))


REPLICATION_POLICIES: dict[str, type] = {
    "static": StaticPolicy,
    "hot-block": HotBlockPolicy,
    # "checkpoint": registered by placement.checkpoint
}


def make_replication_policy(policy=None) -> ReplicationPolicy:
    """Resolve a policy instance from None (static), a registered name,
    or a ready instance."""
    if policy is None:
        return StaticPolicy()
    if isinstance(policy, str):
        try:
            return REPLICATION_POLICIES[policy]()
        except KeyError:
            raise KeyError(
                f"unknown replication policy {policy!r}; "
                f"registered: {sorted(REPLICATION_POLICIES)}"
            ) from None
    if not isinstance(policy, ReplicationPolicy):
        raise TypeError(f"not a replication policy: {policy!r}")
    return policy


def list_replication_policies() -> list[str]:
    return sorted(REPLICATION_POLICIES)
