"""Counters, gauges, and power-of-two histograms for the control plane.

The port's copy of ``repro/obs/metrics.py``.  Besides the session's
registry, :class:`repro_torch.runtime.resilience.ResilienceState` keeps
a private one, whose clone win counters steer the speculation budget
(they change schedules, so they cannot live in an optional session).

:class:`Metrics` is a flat name-keyed registry.  The hot path is a dict
lookup plus an integer add — no allocation, no formatting — so the
scheduler can call it per event.  Histograms bucket by bit length
(bucket ``i`` holds values in ``[2**(i-1), 2**i)``; bucket 0 holds 0),
which is enough resolution for queue depths, latencies in slots, and
microsecond wall times without storing samples.

:meth:`Metrics.snapshot` captures every gauge (and cumulative counter
values) into a row tagged with the sim tick; :meth:`Metrics.to_table`
converts the row history to columnar numpy arrays, and
:meth:`Metrics.save_npz` writes them next to the benchmark artifacts.

Naming convention (``.``-separated, as the reference's
``docs/OBSERVABILITY.md`` catalogues them): ``jobs.*`` lifecycle counts, ``queue.*``
depths, ``busy.*`` eq. 2 levels, ``locality.*`` hit tiers, ``steal.*`` /
``spec.*`` outcome accounting, ``placement.*`` churn, ``serve.*``
latency, ``device.<kind>.*`` dispatch profiling.
"""

from __future__ import annotations

import numpy as np

__all__ = ["Histogram", "Metrics", "perf_regressions"]

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
        self._rows: list[dict[str, float]] = []
        self._row_ticks: list[int] = []

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

    # ---- snapshots -------------------------------------------------------

    def snapshot(self, tick: int) -> None:
        """Record the current gauge values and cumulative counters as one
        row tagged with ``tick``."""
        row: dict[str, float] = {}
        for name, value in self._gauges.items():
            row[f"gauge.{name}"] = value
        for name, value in self._counters.items():
            row[f"counter.{name}"] = float(value)
        self._rows.append(row)
        self._row_ticks.append(int(tick))

    @property
    def n_snapshots(self) -> int:
        return len(self._rows)

    def to_table(self) -> dict[str, np.ndarray]:
        """Snapshot history as columns (missing cells are 0); ``"tick"``
        carries the snapshot ticks.  Histogram summaries ride along as
        scalar ``hist.<name>.<stat>`` columns of length 1."""
        names = sorted({k for row in self._rows for k in row})
        out: dict[str, np.ndarray] = {
            "tick": np.asarray(self._row_ticks, dtype=np.int64)
        }
        for name in names:
            out[name] = np.asarray(
                [row.get(name, 0.0) for row in self._rows], dtype=np.float64
            )
        for name, hist in sorted(self._hists.items()):
            for stat, value in hist.summary().items():
                out[f"hist.{name}.{stat}"] = np.asarray([value], dtype=np.float64)
        return out

    def save_npz(self, path: str) -> None:
        np.savez_compressed(path, **self.to_table())


def _final(table, key: str) -> float:
    arr = np.asarray(table[key]).ravel()
    return float(arr[-1]) if arr.size else 0.0


def perf_regressions(
    old,
    new,
    *,
    threshold: float = 2.0,
    min_value: float = 0.0,
) -> list[dict]:
    """Compare two metric tables (:meth:`Metrics.to_table` dicts or
    loaded ``.npz`` mappings) on the performance-tracking columns:
    control-plane tick-phase host times (``hist.tick.<phase>.us`` mean
    and p99) and cumulative device compile counts
    (``counter.device.<kind>.compiles``, final row).

    Returns one ``{"name", "old", "new", "ratio"}`` record per column
    where ``new > threshold * old`` — including columns absent from the
    old run (``old == 0``, reported with an infinite ratio).  Columns
    whose new value is at or below ``min_value`` are skipped, which is
    the noise floor for sub-microsecond host-time jitter."""
    keys = set(old) & set(new)
    watched = [
        k
        for k in sorted(keys)
        if (
            k.startswith("hist.tick.")
            and (k.endswith(".mean") or k.endswith(".p99"))
        )
        or (k.startswith("counter.device.") and k.endswith(".compiles"))
    ]
    out: list[dict] = []
    for k in watched:
        o, n = _final(old, k), _final(new, k)
        if n <= min_value:
            continue
        if n > threshold * o:
            out.append(
                {
                    "name": k,
                    "old": o,
                    "new": n,
                    "ratio": (n / o) if o else float("inf"),
                }
            )
    return out
