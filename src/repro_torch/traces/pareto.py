"""Pareto-diurnal trace: heavy-tailed task counts under a diurnal load curve.

The port's copy of ``repro/traces/pareto.py`` (the ``pareto_diurnal``
scenario; the same config gives the reference's jobs).  Two departures
from the Alibaba-like scenario, modelling a public cluster's day/night
rhythm:

- **job sizes** are drawn from a Pareto(``pareto_alpha``) tail instead of
  a lognormal body — at α ≤ 2 the largest job routinely owns a double-digit
  share of all tasks, which is the elephant-vs-mice regime where
  reordering (OCWF/SETF) separates from FIFO;
- **arrival rate** is modulated by a sinusoidal diurnal profile
  ``λ(t) ∝ 1 + amplitude·sin(2πt/period)``: peak-hour bursts alternate
  with idle troughs, realised by inverse-transform sampling arrival times
  from the cumulative rate.

Group structure, data placement and capacities follow the shared model in
:mod:`repro_torch.traces.placement`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core import Job

from .placement import build_job, normalize_sizes

__all__ = ["ParetoTraceConfig", "generate_pareto_trace"]


@dataclasses.dataclass(frozen=True)
class ParetoTraceConfig:
    n_jobs: int = 250
    total_tasks: int = 113_653
    n_servers: int = 100
    pareto_alpha: float = 1.5  # tail index; smaller = heavier elephants
    diurnal_period: float = 200.0  # slots per synthetic "day"
    diurnal_amplitude: float = 0.8  # 0 = flat, →1 = near-silent troughs
    mean_groups_per_job: float = 5.52
    zipf_alpha: float = 1.0
    avail_lo: int = 8
    avail_hi: int = 12
    cap_lo: int = 3
    cap_hi: int = 5
    utilization: float = 0.5
    seed: int = 0


def _pareto_sizes(cfg: ParetoTraceConfig, rng: np.random.Generator) -> np.ndarray:
    """Pareto task counts normalised to ``total_tasks`` (largest absorbs
    rounding drift, same ``Σ == total_tasks`` invariant as the lognormal
    sizes via the shared :func:`~repro_torch.traces.placement.normalize_sizes`)."""
    raw = 1.0 + rng.pareto(cfg.pareto_alpha, size=cfg.n_jobs)
    return normalize_sizes(raw, cfg.total_tasks)


def _diurnal_arrivals(
    cfg: ParetoTraceConfig, span: float, rng: np.random.Generator
) -> np.ndarray:
    """Inverse-transform sample ``n_jobs`` arrival slots from the rate
    ``λ(t) ∝ 1 + a·sin(2πt/period)`` over ``[0, span)``."""
    # cumulative rate on a fine grid; Λ is monotone because a < 1
    grid = np.linspace(0.0, span, 4096)
    rate = 1.0 + cfg.diurnal_amplitude * np.sin(2.0 * np.pi * grid / cfg.diurnal_period)
    cum = np.concatenate([[0.0], np.cumsum((rate[1:] + rate[:-1]) * 0.5 * np.diff(grid))])
    cum /= cum[-1]
    u = np.sort(rng.random(cfg.n_jobs))
    return np.floor(np.interp(u, cum, grid)).astype(int)


def generate_pareto_trace(cfg: ParetoTraceConfig, store=None) -> list[Job]:
    """Generate the trace; with a :class:`repro_torch.placement.PlacementStore`
    the jobs are placement-backed (``PlacedJob``, groups registered as
    data blocks) — bit-identical to the frozen trace under a static store."""
    if not 0.0 <= cfg.diurnal_amplitude < 1.0:
        raise ValueError("diurnal_amplitude must be in [0, 1)")
    rng = np.random.default_rng(cfg.seed)
    sizes = _pareto_sizes(cfg, rng)

    mean_mu = (cfg.cap_lo + cfg.cap_hi) / 2.0
    span = float((sizes / mean_mu).sum()) / (cfg.n_servers * cfg.utilization)
    arrivals = _diurnal_arrivals(cfg, span, rng)

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
