"""Open-loop clients: re-time job traces to a target arrival rate.

The port's copy of ``repro/traces/clients.py``.  Closed traces bake
arrival slots into the scenario; an *open-loop* client instead drives
the control plane at a configured rate regardless of how the cluster
keeps up — the standard way to sweep a scheduler across load.  Two
processes are provided:

- :func:`poisson_client` — i.i.d. exponential gaps at ``qps`` jobs per
  slot (memoryless; bursts arise naturally at high rates);
- :func:`replay_client` — deterministic re-timing of an existing trace
  to ``qps`` (job ``i`` arrives at ``⌊i/qps⌋``), preserving the trace's
  size/locality structure exactly.

Both return plain job lists (arrival-retimed copies) that feed
``ControlPlane.submit_many`` — or ``SchedulingEngine.run`` — unchanged.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core import Job

__all__ = ["poisson_client", "replay_client"]


def _retimed(job: Job, arrival: int) -> Job:
    # dataclasses.replace preserves the concrete class, so
    # placement-backed jobs stay placement-backed after re-timing
    return dataclasses.replace(job, arrival=arrival)


def replay_client(
    jobs: list[Job], *, qps: float, start: int = 0
) -> list[Job]:
    """Re-time ``jobs`` (in original arrival order) to a deterministic
    open-loop schedule of ``qps`` jobs per slot."""
    if qps <= 0:
        raise ValueError(f"qps must be positive, got {qps}")
    ordered = sorted(jobs, key=lambda j: (j.arrival, j.job_id))
    return [
        _retimed(job, start + int(i / qps)) for i, job in enumerate(ordered)
    ]


def poisson_client(
    scenario: str | list[Job],
    *,
    qps: float,
    seed: int = 0,
    n_jobs: int | None = None,
    start: int = 0,
    store=None,
    **overrides,
) -> list[Job]:
    """Draw Poisson-process arrivals at ``qps`` jobs per slot over a
    scenario's jobs (by registered name, with config ``overrides``) or
    over an explicit job list."""
    if qps <= 0:
        raise ValueError(f"qps must be positive, got {qps}")
    if isinstance(scenario, str):
        from . import generate  # deferred: clients ⊂ traces

        jobs = generate(scenario, store=store, **overrides)
    else:
        if store is not None or overrides:
            raise ValueError(
                "store/config overrides only apply to scenario names"
            )
        jobs = list(scenario)
    if n_jobs is not None:
        jobs = sorted(jobs, key=lambda j: (j.arrival, j.job_id))[:n_jobs]
    rng = np.random.default_rng(seed)
    times = start + np.cumsum(rng.exponential(1.0 / qps, size=len(jobs)))
    ordered = sorted(jobs, key=lambda j: (j.arrival, j.job_id))
    return [
        _retimed(job, int(t)) for job, t in zip(ordered, times)
    ]
