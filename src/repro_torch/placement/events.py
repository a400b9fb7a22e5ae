"""Placement-change events: replica churn injected into the engine.

The port's copy of ``repro/placement/events.py``.  Mirrors
:mod:`repro_torch.runtime.events` (fault/straggler timeline) for the
placement layer: a :class:`PlacementEvent` is applied by the scheduling
engine at the top of its slot, next to server faults — an ``evict``
strands the affected queued fragments exactly like a server failure
does, an ``add`` widens eligible sets of queued and future jobs, and a
``rebalance`` runs the store's replication policy (propose on the
engine's side so evictions go through the stranding path).

Event kinds:

- ``add``       — ``server`` gains a replica of ``block``;
- ``evict``     — ``server`` drops its replica of ``block`` (a stale
  pair — the replica is already gone — is a documented no-op, so churn
  timelines can be generated from a build-time snapshot);
- ``join``      — ``server`` becomes placement-active again;
- ``leave``     — ``server`` leaves placement: every replica it holds is
  evicted (the machine itself may still be alive — contrast with the
  fault timeline's ``fail``, which kills the queues too);
- ``rebalance`` — run the store's replication policy with an rng seeded
  from ``seed`` (kept in the event so timelines stay deterministic).

:func:`churn_timeline` generates the standard churn workload: periodic
rebalances plus Bernoulli replica evictions sampled from a build-time
placement snapshot.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:  # pragma: no cover
    from .store import PlacementStore

__all__ = ["PlacementEvent", "churn_timeline"]


@dataclasses.dataclass(frozen=True)
class PlacementEvent:
    """A placement-change event injected at the start of a slot."""

    slot: int
    kind: str  # "add" | "evict" | "join" | "leave" | "rebalance"
    block: str | None = None
    server: int | None = None
    seed: int = 0  # rng seed for "rebalance" (keeps timelines deterministic)

    _KINDS = ("add", "evict", "join", "leave", "rebalance")

    def __post_init__(self) -> None:
        if self.kind not in self._KINDS:
            raise ValueError(
                f"unknown placement event kind {self.kind!r}; "
                f"expected one of {self._KINDS}"
            )
        if self.kind in ("add", "evict") and (
            self.block is None or self.server is None
        ):
            raise ValueError(f"{self.kind!r} event needs both block and server")
        if self.kind in ("join", "leave") and self.server is None:
            raise ValueError(f"{self.kind!r} event needs a server")


def churn_timeline(
    store: "PlacementStore",
    *,
    horizon: int,
    rebalance_every: int = 0,
    evict_rate: float = 0.0,
    seed: int = 0,
) -> tuple[PlacementEvent, ...]:
    """Deterministic churn workload over ``[1, horizon)`` slots.

    - ``rebalance_every > 0`` → a ``rebalance`` event every that many
      slots (each carrying its own derived seed);
    - ``evict_rate`` → per-slot probability of evicting one uniformly
      chosen replica, sampled from the store's *current* snapshot.
      Replicas that have already moved by the time an event fires make
      the event a no-op (the engine checks the store), so pre-generated
      timelines stay valid under arbitrary interleaving.

    The eviction and rebalance streams draw from *independent* child
    rngs of ``seed``, so sweeping the rebalance cadence never changes
    which replicas get evicted — cells of a cadence sweep stay
    comparable.
    """
    if horizon <= 0:
        raise ValueError("churn horizon must be positive")
    if not 0.0 <= evict_rate <= 1.0:
        raise ValueError("evict_rate must be a probability")
    rng_evict = np.random.default_rng([seed, 0])
    rng_rebalance = np.random.default_rng([seed, 1])
    events: list[PlacementEvent] = []
    if rebalance_every > 0:
        for slot in range(rebalance_every, horizon, rebalance_every):
            events.append(
                PlacementEvent(
                    slot,
                    "rebalance",
                    seed=int(rng_rebalance.integers(0, 2**31 - 1)),
                )
            )
    if evict_rate > 0.0:
        snapshot = [
            (block, server)
            for block, servers in sorted(store.snapshot().items())
            for server in servers
        ]
        if snapshot and horizon > 1:
            # one Bernoulli draw per slot in [1, horizon) — matching the
            # rebalance stream's window
            for i in np.flatnonzero(rng_evict.random(horizon - 1) < evict_rate):
                block, server = snapshot[int(rng_evict.integers(len(snapshot)))]
                events.append(
                    PlacementEvent(
                        int(i) + 1, "evict", block=block, server=server
                    )
                )
    return tuple(sorted(events, key=lambda e: e.slot))
