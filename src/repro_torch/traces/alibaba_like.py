"""Synthetic job trace matched to the paper's Alibaba-v2017 segment.

The paper (Sec. V-A) extracts 250 jobs / 113,653 tasks from
``cluster-trace-v2017/batch_task.csv``; each trace *entry* (task event) is
one task group, averaging 5.52 groups per job.  The real CSV is not
part of the repository, so this module generates a trace matched to the
described statistics:

- 250 jobs, ~113k tasks total, heavy-tailed job sizes (lognormal);
- group counts ~ shifted-Poisson with mean ≈ 5.52 (≥1);
- group sizes ~ Dirichlet split of the job's tasks (skewed);
- bursty Poisson arrivals, scaled so that offered load = target utilization;
- data placement per group: Zipf(α)-weighted choice of an anchor server in
  a random permutation, then ``p`` consecutive servers (mod M) are the
  group's available set — exactly the paper's placement model;
- per-(server, job) capacities ``μ_m^c ~ U{cap_lo..cap_hi}`` (default 3..5).

Everything is seeded and deterministic.  The group/placement/capacity
model is shared with the bursty scenario via
:mod:`repro_torch.traces.placement`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core import Job

from .placement import build_job, lognormal_sizes

__all__ = ["TraceConfig", "generate_trace"]


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    n_jobs: int = 250
    total_tasks: int = 113_653
    n_servers: int = 100
    mean_groups_per_job: float = 5.52
    zipf_alpha: float = 1.0  # data-placement skew α ∈ [0, 2]
    avail_lo: int = 8  # p ~ U{avail_lo..avail_hi} available servers per group
    avail_hi: int = 12
    cap_lo: int = 3  # μ_m^c ~ U{cap_lo..cap_hi}
    cap_hi: int = 5
    utilization: float = 0.5  # offered load: fraction of cluster capacity
    seed: int = 0


def generate_trace(cfg: TraceConfig, store=None) -> list[Job]:
    """Generate the trace (identical to the reference's for the same
    config); with a :class:`repro_torch.placement.PlacementStore` the
    jobs are placement-backed (``PlacedJob``, groups registered as data
    blocks) — bit-identical to the frozen trace under a static store."""
    rng = np.random.default_rng(cfg.seed)
    sizes = lognormal_sizes(cfg.n_jobs, cfg.total_tasks, rng)

    mean_mu = (cfg.cap_lo + cfg.cap_hi) / 2.0
    # offered work per job in expected server-slots
    work = sizes / mean_mu
    # arrival span so that Σ work / (M · span) = utilization
    span = float(work.sum()) / (cfg.n_servers * cfg.utilization)
    gaps = rng.exponential(1.0, size=cfg.n_jobs)
    arrivals = np.floor(np.cumsum(gaps) / gaps.sum() * span).astype(int)

    return [
        build_job(
            j,
            int(arrivals[j]),
            int(sizes[j]),
            n_servers=cfg.n_servers,
            mean_groups=cfg.mean_groups_per_job,
            zipf_alpha=cfg.zipf_alpha,
            avail_lo=cfg.avail_lo,
            avail_hi=cfg.avail_hi,
            cap_lo=cfg.cap_lo,
            cap_hi=cfg.cap_hi,
            rng=rng,
            store=store,
        )
        for j in range(cfg.n_jobs)
    ]
