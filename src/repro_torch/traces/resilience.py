"""Resilience drills: overload re-timing and correlated-fault timelines.

The port's copy of ``repro/traces/resilience.py``.  Helpers that turn
any scenario's job list into an adversarial drive for the control
plane's hardening mechanisms (:mod:`repro_torch.runtime.resilience`):

- :func:`saturation_qps` — the open-loop arrival rate at which offered
  load matches cluster service capacity (ρ = 1) for a job mix;
- :func:`overload_client` — deterministic re-timing of a trace to a
  target *utilisation* ρ (ρ > 1 is sustained overload, the regime
  admission control and load shedding exist for);
- :func:`rack_failure_timeline` — a correlated fault: one
  :class:`~repro_torch.runtime.events.RackEvent` takes a whole server block
  down at once, with an optional recovery — the drill for
  retry-with-backoff surviving the loss of every live replica.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np

from ..core import Job
from ..runtime.events import RackEvent

from .clients import replay_client

__all__ = ["overload_client", "rack_failure_timeline", "saturation_qps"]


def saturation_qps(jobs: list[Job], n_servers: int) -> float:
    """The arrival rate (jobs/slot) at which offered load
    ``ρ = qps·E[tasks/job] / (M·E[μ])`` reaches 1 for this job mix on
    ``n_servers`` servers — the knee where queueing explodes."""
    if not jobs:
        raise ValueError("need a non-empty job list")
    mean_mu = float(np.mean([j.mu.mean() for j in jobs]))
    mean_tasks = float(np.mean([j.n_tasks for j in jobs]))
    return n_servers * mean_mu / mean_tasks


def overload_client(
    jobs: list[Job], *, rho: float, n_servers: int, start: int = 0
) -> list[Job]:
    """Re-time ``jobs`` to utilisation ``rho`` (via
    :func:`~repro_torch.traces.clients.replay_client`, so the trace's
    size/locality structure is preserved exactly).  ``rho > 1`` offers
    more work per slot than the cluster can serve — without admission
    control the backlog, and with it the shed count, grows without
    bound for as long as the client keeps submitting."""
    if rho <= 0:
        raise ValueError(f"rho must be positive, got {rho}")
    return replay_client(
        jobs, qps=rho * saturation_qps(jobs, n_servers), start=start
    )


def rack_failure_timeline(
    servers: Iterable[int], *, fail_at: int, recover_at: int | None = None
) -> tuple[RackEvent, ...]:
    """A fail (and optional later recover) event over one server block.

    Jobs whose every replica lives inside ``servers`` lose all of them
    in the same slot; with ``recover_at`` set after the retry backoff
    window, a retrying control plane re-places them on the recovered
    rack instead of failing them."""
    events = [RackEvent(fail_at, "fail", tuple(servers))]
    if recover_at is not None:
        if recover_at <= fail_at:
            raise ValueError(
                f"recover_at ({recover_at}) must be after fail_at ({fail_at})"
            )
        events.append(RackEvent(recover_at, "recover", tuple(servers)))
    return tuple(events)
