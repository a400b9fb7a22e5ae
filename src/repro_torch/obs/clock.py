"""The one wall-clock surface of the port (copy of ``repro/obs/clock.py``).

The engine's per-arrival overhead column, the control plane's tick-phase
spans and the device profiler around the ``wf_torch``/``rd_torch``
adapters and serve decode read :func:`perf_counter` from here instead of
:mod:`time`.  Wall time read through this module is measurement only:
nothing feeds it back into a scheduling decision.
"""

from __future__ import annotations

import time

__all__ = ["perf_counter", "us_since"]

perf_counter = time.perf_counter


def us_since(t0: float) -> int:
    """Whole microseconds elapsed since ``t0`` (a :func:`perf_counter`
    reading) — the host-time unit of trace events."""
    return int((perf_counter() - t0) * 1e6)
