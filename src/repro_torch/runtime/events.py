"""Cluster event timeline: fault/straggler events injected into the engine.

Arrivals are carried by the jobs themselves (``Job.arrival``); this module
covers everything *else* that changes cluster state mid-run — server
failures, recoveries, slowdowns and speedups — as a sorted timeline the
engine drains at the top of each slot.

:class:`RackEvent` is the correlated-fault variant: one event fails (or
recovers) a whole server set at once, modeling a rack/locality-tier
outage.  The engine strands every affected queue in the same slot and
merges each job's fragments across the rack before re-placement, so a
job split over the rack is re-balanced jointly — and a job whose last
live replica was on the rack takes the retry-with-backoff path when
:class:`repro_torch.runtime.resilience.ResilienceConfig` enables it.

The port's copy of ``repro/runtime/events.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator

__all__ = ["RackEvent", "ServerEvent", "EventTimeline"]


@dataclasses.dataclass(frozen=True)
class ServerEvent:
    """A fault/straggler event injected at the start of a slot."""

    slot: int
    kind: str  # "fail" | "recover" | "slowdown" | "speedup"
    server: int
    factor: float = 2.0  # slowdown divisor

    _KINDS = ("fail", "recover", "slowdown", "speedup")

    def __post_init__(self) -> None:
        if self.kind not in self._KINDS:
            raise ValueError(
                f"unknown event kind {self.kind!r}; expected one of {self._KINDS}"
            )


@dataclasses.dataclass(frozen=True)
class RackEvent:
    """A correlated fault: every server in ``servers`` fails (or
    recovers) at the start of one slot — a whole locality group going
    dark at once, the failure mode replication is supposed to survive."""

    slot: int
    kind: str  # "fail" | "recover"
    servers: tuple[int, ...]

    _KINDS = ("fail", "recover")

    def __post_init__(self) -> None:
        if self.kind not in self._KINDS:
            raise ValueError(
                f"unknown rack event kind {self.kind!r}; "
                f"expected one of {self._KINDS}"
            )
        if not self.servers:
            raise ValueError("RackEvent needs a non-empty server set")
        object.__setattr__(self, "servers", tuple(sorted(set(self.servers))))


class EventTimeline:
    """Slot-ordered event queue with a drain cursor."""

    def __init__(self, events: Iterable[ServerEvent] = ()):
        self._events = sorted(events, key=lambda e: e.slot)
        self._next = 0

    def __len__(self) -> int:
        return len(self._events)

    def reset(self) -> None:
        self._next = 0

    def due(self, slot: int) -> Iterator[ServerEvent]:
        """Yield (and consume) every event with ``event.slot <= slot``."""
        while self._next < len(self._events) and self._events[self._next].slot <= slot:
            ev = self._events[self._next]
            self._next += 1
            yield ev
