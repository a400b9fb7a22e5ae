"""Shared building blocks for the synthetic job traces.

The port's copy of ``repro/traces/placement.py``.  Every scenario (the
synthetic ones and the ``cluster_v2017`` CSV replay) composes the same ingredients from the paper's Sec. V-A
setup:

- heavy-tailed per-job task counts normalised to a target total;
- a shifted-Poisson split of each job's tasks into task groups with a
  skewed Dirichlet allocation;
- the paper's data-placement model: a Zipf(α)-ranked anchor server in a
  random permutation, then ``p`` consecutive servers (mod M) form the
  group's available set.

Placement can be frozen (``build_job`` bakes the server tuples into the
trace) or *store-backed*: pass a
:class:`repro_torch.placement.PlacementStore` and each group becomes a
named data block registered in the store, returned as a
:class:`repro_torch.placement.PlacedJob` whose eligible sets the engine
re-resolves at arrival time.  Both paths consume the RNG identically, in
exactly the reference's order, so a config gives the reference's jobs,
and with a static store the trace is bit-identical to the frozen one.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np

from ..core import Job, TaskGroup
from ..placement.store import PlacedJob, data_block, zipf_servers

if TYPE_CHECKING:  # pragma: no cover
    from ..placement import PlacementStore

__all__ = [
    "group_split",
    "normalize_sizes",
    "lognormal_sizes",
    "build_job",
]


def normalize_sizes(raw: np.ndarray, total_tasks: int) -> np.ndarray:
    """Integer job sizes proportional to ``raw``, each ≥ 1, summing to
    ``total_tasks`` exactly.

    Rounding drift lands on the largest job; if absorbing a deficit
    pushes anything below 1, the undersized jobs are raised to 1 and the
    excess is shaved off the largest jobs (each kept ≥ 1).
    """
    n = len(raw)
    if total_tasks < n:
        raise ValueError(
            f"cannot split {total_tasks} tasks into {n} jobs of ≥1 task each"
        )
    sizes = np.maximum(1, np.round(raw / raw.sum() * total_tasks)).astype(int)
    sizes[np.argmax(sizes)] += total_tasks - int(sizes.sum())
    if sizes.min() < 1:
        sizes = np.maximum(sizes, 1)
        excess = int(sizes.sum()) - total_tasks
        for i in np.argsort(sizes, kind="stable")[::-1]:
            if excess <= 0:
                break
            take = min(excess, int(sizes[i]) - 1)
            sizes[i] -= take
            excess -= take
    return sizes


def lognormal_sizes(
    n_jobs: int, total_tasks: int, rng: np.random.Generator, sigma: float = 1.6
) -> np.ndarray:
    """Heavy-tailed task counts summing to ``total_tasks``."""
    return normalize_sizes(
        rng.lognormal(mean=0.0, sigma=sigma, size=n_jobs), total_tasks
    )


def group_split(
    n_tasks: int, mean_groups: float, rng: np.random.Generator
) -> list[int]:
    """Split a job's tasks into ≥1 groups, mean count ≈ ``mean_groups``."""
    k = max(1, min(n_tasks, 1 + rng.poisson(mean_groups - 1.0)))
    if k == 1:
        return [n_tasks]
    w = rng.dirichlet(np.full(k, 0.8))
    sizes = np.maximum(1, np.round(w * n_tasks)).astype(int)
    sizes[np.argmax(sizes)] += n_tasks - int(sizes.sum())
    while sizes.min() < 1:  # the fix above can push a bucket negative
        i, j = np.argmin(sizes), np.argmax(sizes)
        sizes[j] += sizes[i] - 1
        sizes[i] = 1
    return [int(s) for s in sizes]


def build_job(
    job_id: int,
    arrival: int,
    n_tasks: int,
    *,
    n_servers: int,
    mean_groups: float = 0.0,
    zipf_alpha: float,
    avail_lo: int,
    avail_hi: int,
    cap_lo: int,
    cap_hi: int,
    rng: np.random.Generator,
    store: "PlacementStore | None" = None,
    group_sizes: list[int] | None = None,
) -> Job:
    """One job under the shared group/placement/capacity model.

    With ``store`` given, every group's replica set is registered as a
    ``data/j<job>/g<k>`` block and the returned job is a
    :class:`~repro_torch.placement.PlacedJob` carrying the block names;
    the RNG stream is consumed identically either way.
    """
    if group_sizes is None:
        if mean_groups <= 0:
            raise ValueError(
                "build_job needs mean_groups > 0 or explicit group_sizes"
            )
        sizes = group_split(n_tasks, mean_groups, rng)
    else:
        sizes = group_sizes
    if store is None:
        groups = tuple(
            TaskGroup(gs, zipf_servers(n_servers, rng, zipf_alpha, avail_lo, avail_hi))
            for gs in sizes
        )
        mu = rng.integers(cap_lo, cap_hi + 1, size=n_servers)
        return Job(job_id=job_id, arrival=arrival, groups=groups, mu=mu)
    if store.n_servers != n_servers:
        raise ValueError(
            f"placement store spans {store.n_servers} servers, "
            f"trace wants {n_servers}"
        )
    blocks = [data_block(job_id, k) for k in range(len(sizes))]
    groups = tuple(
        TaskGroup(
            gs,
            store.place_block(
                block, rng, zipf_alpha=zipf_alpha, avail_lo=avail_lo, avail_hi=avail_hi
            ),
        )
        for gs, block in zip(sizes, blocks)
    )
    mu = rng.integers(cap_lo, cap_hi + 1, size=n_servers)
    return PlacedJob(
        job_id=job_id, arrival=arrival, groups=groups, mu=mu, blocks=tuple(blocks)
    )
