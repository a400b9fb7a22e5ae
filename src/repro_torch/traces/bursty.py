"""Bursty-arrival trace: Poisson bursts of simultaneous job arrivals.

The Alibaba-like scenario spreads arrivals smoothly; real cluster front
doors see *bursts* — a user submits a DAG, a cron tick fires, a retry
storm lands — where many jobs arrive in the same scheduling slot.  This
scenario makes burst size a first-class knob:

- burst epochs: exponential inter-burst gaps (a Poisson process over
  slots), scaled so offered load matches ``utilization``;
- burst sizes: 1 + Poisson(``mean_burst - 1``) jobs, all sharing the
  epoch's arrival slot;
- everything else (sizes, groups, placement, capacities) follows the
  shared model in :mod:`repro_torch.traces.placement`.

Same-slot arrivals are exactly the case the chained on-device water
level (:func:`repro_torch.core.wf_torch.water_filling_torch_chain`)
places in one pass, and the case where FIFO vs. reordering policies
diverge the most.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core import Job

from .placement import build_job, lognormal_sizes

__all__ = ["BurstyTraceConfig", "generate_bursty_trace"]


@dataclasses.dataclass(frozen=True)
class BurstyTraceConfig:
    n_jobs: int = 250
    total_tasks: int = 113_653
    n_servers: int = 100
    mean_burst: float = 6.0  # mean jobs per burst (≥ 1)
    mean_groups_per_job: float = 5.52
    zipf_alpha: float = 1.0
    avail_lo: int = 8
    avail_hi: int = 12
    cap_lo: int = 3
    cap_hi: int = 5
    utilization: float = 0.5
    seed: int = 0


def generate_bursty_trace(cfg: BurstyTraceConfig, store=None) -> list[Job]:
    """Generate the trace (identical to the reference's for the same
    config); with a :class:`repro_torch.placement.PlacementStore` the
    jobs are placement-backed (``PlacedJob``, groups registered as data
    blocks) — bit-identical to the frozen trace under a static store."""
    rng = np.random.default_rng(cfg.seed)
    sizes = lognormal_sizes(cfg.n_jobs, cfg.total_tasks, rng)

    # carve the job sequence into bursts
    burst_sizes: list[int] = []
    assigned = 0
    while assigned < cfg.n_jobs:
        b = 1 + int(rng.poisson(max(cfg.mean_burst - 1.0, 0.0)))
        b = min(b, cfg.n_jobs - assigned)
        burst_sizes.append(b)
        assigned += b

    # burst epochs: exponential gaps normalised to the span that realises
    # the target utilization (same load accounting as the Alibaba scenario)
    mean_mu = (cfg.cap_lo + cfg.cap_hi) / 2.0
    span = float((sizes / mean_mu).sum()) / (cfg.n_servers * cfg.utilization)
    gaps = rng.exponential(1.0, size=len(burst_sizes))
    epochs = np.floor(np.cumsum(gaps) / gaps.sum() * span).astype(int)

    jobs: list[Job] = []
    j = 0
    for epoch, b in zip(epochs, burst_sizes):
        for _ in range(b):
            jobs.append(
                build_job(
                    j,
                    int(epoch),
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
            )
            j += 1
    return jobs
