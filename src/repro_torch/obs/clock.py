"""The one wall-clock surface of the port (copy of ``repro/obs/clock.py``).

The engine's per-arrival overhead column reads :func:`perf_counter`
from here instead of :mod:`time`.  Wall time read through this module is
measurement only: nothing feeds it back into a scheduling decision.
"""

from __future__ import annotations

import time

__all__ = ["perf_counter"]

perf_counter = time.perf_counter
