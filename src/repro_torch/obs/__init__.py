"""`repro_torch.obs`: schedule-invariant observability for the port.

The port's copy of ``repro.obs``; three surfaces, one session object:

- **tracing** (:mod:`repro_torch.obs.trace`) — typed span/instant events
  in a ring buffer: job lifecycle with steal/speculation/reassignment
  causality links, control-plane tick phases, placement churn, serve
  spans, device dispatches.  Exports Chrome/Perfetto ``trace_event``
  JSON and a columnar numpy table.
- **metrics** (:mod:`repro_torch.obs.metrics`) — counters, gauges, and
  power-of-two histograms, snapshotted per tick at a configurable
  cadence.
- **device profiling** (:class:`repro_torch.obs.session.DeviceProfiler`)
  — first-launch ("compile") versus later-launch wall time around the
  ``wf_torch``/``rd_torch`` adapters and serve decode, keyed by the
  kernelcheck signatures, plus host-fallback counts.

Everything hangs off :class:`ObsSession`, activated ambiently::

    from repro_torch import obs

    with obs.observe() as session:
        result = SchedulingEngine(...).run(jobs)
    json.dump(session.trace.to_chrome_trace(), open("run.trace.json", "w"))

The hard contract — proven by ``tests/test_torch_obs.py`` — is that
observability **on ≡ off is schedule-identical**: hooks never mutate
scheduler state, never launch a kernel or draw random numbers, and wall
time flows only *out* through :mod:`repro_torch.obs.clock`.  The trace
records that carry sim time equal the reference's, record for record.
This package imports only numpy and the stdlib.

``python -m repro_torch.obs.report`` runs a scenario under a session and
writes the trace + metrics artifacts.
"""

from __future__ import annotations

from . import clock
from .metrics import Histogram, Metrics
from .session import (
    DeviceProfiler,
    ObsSession,
    active,
    device_profiler,
    observe,
)
from .trace import KIND_NAMES, SLOT_US, TraceRecorder, parse_chrome_trace

__all__ = [
    "clock",
    "Histogram",
    "Metrics",
    "DeviceProfiler",
    "ObsSession",
    "active",
    "device_profiler",
    "observe",
    "KIND_NAMES",
    "SLOT_US",
    "TraceRecorder",
    "parse_chrome_trace",
]
