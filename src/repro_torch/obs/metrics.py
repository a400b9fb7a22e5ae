"""Counters, gauges, and power-of-two histograms for the control plane.

The port's copy of ``Histogram`` and ``Metrics`` from
``repro/obs/metrics.py``.  :class:`Metrics` is a flat name-keyed
registry: the hot path is a dict lookup plus an integer add.  Histograms
bucket by bit length (bucket ``i`` holds values in ``[2**(i-1), 2**i)``;
bucket 0 holds 0).

In this slice its one user is the private registry of
:class:`repro_torch.runtime.resilience.ResilienceState`, whose clone
win counters steer the speculation budget (so they change schedules).
The reference's snapshot tables (``snapshot`` / ``to_table`` /
``save_npz``), ``perf_regressions`` and the session that reads them
belong to the observability slice.
"""

from __future__ import annotations

import numpy as np

__all__ = ["Histogram", "Metrics"]

_NBUCKETS = 64


class Histogram:
    """Power-of-two histogram over non-negative integers."""

    __slots__ = ("buckets", "count", "total", "max")

    def __init__(self) -> None:
        self.buckets = np.zeros(_NBUCKETS, dtype=np.int64)
        self.count = 0
        self.total = 0
        self.max = 0

    def observe(self, value: int) -> None:
        v = int(value)
        if v < 0:
            v = 0
        self.buckets[min(v.bit_length(), _NBUCKETS - 1)] += 1
        self.count += 1
        self.total += v
        if v > self.max:
            self.max = v

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def quantile(self, q: float) -> int:
        """Upper bound of the bucket holding the ``q``-quantile sample
        (0 when empty)."""
        if not self.count:
            return 0
        target = q * self.count
        acc = 0
        for i in range(_NBUCKETS):
            acc += int(self.buckets[i])
            if acc >= target:
                return (1 << i) - 1 if i else 0
        return self.max

    def summary(self) -> dict[str, float]:
        return {
            "count": float(self.count),
            "mean": self.mean,
            "p50": float(self.quantile(0.5)),
            "p99": float(self.quantile(0.99)),
            "max": float(self.max),
        }


class Metrics:
    """Flat registry of counters, gauges, and histograms."""

    def __init__(self) -> None:
        self._counters: dict[str, int] = {}
        self._gauges: dict[str, float] = {}
        self._hists: dict[str, Histogram] = {}

    # ---- write path ------------------------------------------------------

    def inc(self, name: str, delta: int = 1) -> None:
        self._counters[name] = self._counters.get(name, 0) + int(delta)

    def set_gauge(self, name: str, value: float) -> None:
        self._gauges[name] = float(value)

    def observe(self, name: str, value: int) -> None:
        hist = self._hists.get(name)
        if hist is None:
            hist = self._hists[name] = Histogram()
        hist.observe(value)

    # ---- read path -------------------------------------------------------

    def counter(self, name: str) -> int:
        return self._counters.get(name, 0)

    def gauge(self, name: str) -> float:
        return self._gauges.get(name, 0.0)

    def histogram(self, name: str) -> Histogram | None:
        return self._hists.get(name)

    @property
    def counters(self) -> dict[str, int]:
        return dict(self._counters)

    @property
    def gauges(self) -> dict[str, float]:
        return dict(self._gauges)

    @property
    def histograms(self) -> dict[str, Histogram]:
        return dict(self._hists)
