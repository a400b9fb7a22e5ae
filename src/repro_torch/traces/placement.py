"""Shared building blocks for the synthetic job traces.

The part of ``repro/traces/placement.py`` (and of
``repro/placement/store.py``'s ``zipf_weights`` / ``zipf_servers``) that
the ``alibaba`` and ``bursty`` scenarios use.  Every scenario composes the
same ingredients from the paper's Sec. V-A setup:

- heavy-tailed per-job task counts normalised to a target total;
- a shifted-Poisson split of each job's tasks into task groups with a
  skewed Dirichlet allocation;
- the paper's data-placement model: a Zipf(α)-ranked anchor server in a
  random permutation, then ``p`` consecutive servers (mod M) form the
  group's available set.

The RNG is consumed in exactly the reference's order, so a config gives
the reference's jobs.  Placement-backed jobs (``store=``) belong to a
later slice of the port.
"""

from __future__ import annotations

import numpy as np

from ..core import Job, TaskGroup

__all__ = [
    "zipf_weights",
    "zipf_servers",
    "group_split",
    "normalize_sizes",
    "lognormal_sizes",
    "build_job",
]


def zipf_weights(n: int, alpha: float) -> np.ndarray:
    """Normalized Zipf(α) rank weights."""
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** alpha
    return w / w.sum()


def zipf_servers(
    n_servers: int,
    rng: np.random.Generator,
    zipf_alpha: float,
    avail_lo: int,
    avail_hi: int,
) -> tuple[int, ...]:
    """The paper's placement model (Sec. V-A): a Zipf(α)-ranked anchor
    server in a random permutation, then ``p ~ U{avail_lo..avail_hi}``
    consecutive servers (mod M) form the replica set."""
    perm = rng.permutation(n_servers)
    anchor = int(perm[rng.choice(n_servers, p=zipf_weights(n_servers, zipf_alpha))])
    p = int(rng.integers(avail_lo, avail_hi + 1))
    return tuple(sorted({(anchor + i) % n_servers for i in range(p)}))


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
    mean_groups: float,
    zipf_alpha: float,
    avail_lo: int,
    avail_hi: int,
    cap_lo: int,
    cap_hi: int,
    rng: np.random.Generator,
) -> Job:
    """One job under the shared group/placement/capacity model."""
    if mean_groups <= 0:
        raise ValueError("build_job needs mean_groups > 0")
    sizes = group_split(n_tasks, mean_groups, rng)
    groups = tuple(
        TaskGroup(gs, zipf_servers(n_servers, rng, zipf_alpha, avail_lo, avail_hi))
        for gs in sizes
    )
    mu = rng.integers(cap_lo, cap_hi + 1, size=n_servers)
    return Job(job_id=job_id, arrival=arrival, groups=groups, mu=mu)
