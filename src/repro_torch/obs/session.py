"""The observability session: one object carrying trace + metrics +
device profiling for one run, plus the ambient-activation protocol.

The port's copy of ``repro/obs/session.py``.  Instrumentation sites
resolve their session in one of two ways:

- **constructed layers** (:class:`repro_torch.runtime.loop.ControlPlane`,
  :class:`repro_torch.runtime.engine.SchedulingEngine`,
  :class:`repro_torch.runtime.cluster.ClusterState`) take an explicit
  ``obs=`` parameter that defaults to the ambient :func:`active` session
  at construction;
- **module-level layers** (the ``wf_torch``/``rd_torch`` adapters,
  :class:`repro_torch.placement.store.PlacementStore`, the serve engines)
  read :func:`active` / :func:`device_profiler` per call.

Either way a disabled run pays one attribute/None check per site and
nothing else.  Activate with::

    from repro_torch import obs

    with obs.observe() as session:
        result = engine.run(jobs)
    chrome = session.trace.to_chrome_trace()
    session.metrics.to_table()

**Schedule invariance is the contract**: every hook is observation-only.
No hook mutates cluster or queue state, launches a kernel, synchronises
the stream beyond what its adapter already does, draws random numbers,
or feeds a wall-clock reading back into a decision — so a run with a
session active is schedule-identical (bit-identical ``SimResult``) to
one without, which ``tests/test_torch_obs.py`` proves across scenarios ×
orderings.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

from . import clock
from .metrics import Metrics
from .trace import (
    INST_ADMIT,
    INST_ARRIVAL,
    INST_DEVICE,
    INST_FAILED,
    INST_FIRST_SERVICE,
    INST_PLACEMENT,
    INST_REASSIGN,
    INST_SPEC_LAUNCH,
    INST_SPEC_RESOLVE,
    INST_STEAL,
    SPAN_JOB,
    SPAN_SERVE,
    SPAN_TICK,
    TraceRecorder,
)

__all__ = ["ObsSession", "DeviceProfiler", "observe", "active", "device_profiler"]

# spec-pair resolution codes (INST_SPEC_RESOLVE.b)
SPEC_ORIGINAL_WON = 0
SPEC_CLONE_WON = 1
SPEC_ABORTED = 2


class DeviceProfiler:
    """Wall-time + jit-cache accounting around device dispatches.

    The first call for a given kernelcheck signature (``("wf-groups",
    lanes, k, route)``, ``("rd-device", m, c_slots, row_ids)``, ...) is
    the first launch of that kernel variant: the lazy ``nvcc`` build of
    :mod:`repro_torch.kernels._build`, the library load and the module's
    first launch land in it, so its wall time is attributed to
    ``compile_us``; later calls with the same signature land in
    ``exec_us``.  Host fallbacks (RD's overflow re-run, holder rows past
    the step kernel's ceiling) are counted separately — their wall time
    is genuine scheduling cost, not device time.  The adapters record
    only after their own host read of the result, so a wall covers the
    whole launch.
    """

    def __init__(self, session: "ObsSession"):
        self._session = session
        self._seen: set[tuple] = set()

    def start(self) -> float:
        return clock.perf_counter()

    def record(
        self, kind: str, sig: tuple, t0: float, *, fallback: bool = False
    ) -> None:
        wall_us = clock.us_since(t0)
        key = (kind, sig)
        miss = key not in self._seen
        if miss:
            self._seen.add(key)
        s = self._session
        m = s.metrics
        m.inc(f"device.{kind}.calls")
        if miss:
            m.inc(f"device.{kind}.compiles")
            m.observe(f"device.{kind}.compile_us", wall_us)
        else:
            m.observe(f"device.{kind}.exec_us", wall_us)
        if fallback:
            m.inc(f"device.{kind}.host_fallback")
        trace = s.trace
        if trace is not None:
            trace.record(
                INST_DEVICE,
                ts=s.host_us(t0),
                dur=wall_us,
                a=trace.intern(f"{kind}{sig}"),
                b=(1 if miss else 0) | (2 if fallback else 0),
                c=wall_us,
            )


class ObsSession:
    """Trace recorder + metrics registry + device profiler for one run."""

    def __init__(
        self,
        *,
        trace: bool = True,
        trace_capacity: int = 1 << 16,
        metrics_every: int = 1,
        device: bool = True,
    ):
        self.trace: TraceRecorder | None = (
            TraceRecorder(trace_capacity) if trace else None
        )
        self.metrics = Metrics()
        self.metrics_every = max(1, int(metrics_every))
        self.device: DeviceProfiler | None = (
            DeviceProfiler(self) if device else None
        )
        # current sim slot, kept fresh by the driving loop so layers
        # without their own clock (cluster, store) can timestamp events
        self.sim_now = 0
        self._t0 = clock.perf_counter()
        self._flow = 0
        self._started: set[int] = set()
        self._serve_submit: dict[int, tuple[int, int]] = {}  # rid -> (t, tokens)
        self._last_snap: int | None = None

    # ---- time bases ------------------------------------------------------

    def host_us(self, t: float) -> int:
        """A perf_counter reading as microseconds since session start."""
        return int((t - self._t0) * 1e6)

    def _next_flow(self) -> int:
        self._flow += 1
        return self._flow

    # ---- job lifecycle ---------------------------------------------------

    def job_arrival(self, t: int, job_id: int, n_tasks: int) -> None:
        self.metrics.inc("jobs.arrived")
        if self.trace is not None:
            self.trace.record(INST_ARRIVAL, ts=t, a=job_id, c=n_tasks)

    def job_admitted(self, t: int, job_id: int, overhead_s: float) -> None:
        self.metrics.inc("jobs.admitted")
        self.metrics.observe("sched.overhead_us", int(overhead_s * 1e6))
        if self.trace is not None:
            self.trace.record(
                INST_ADMIT, ts=t, a=job_id, c=int(overhead_s * 1e9)
            )

    def service_progress(self, t: int, job_id: int, n_done: int) -> None:
        if job_id not in self._started:
            self._started.add(job_id)
            self.metrics.inc("jobs.started")
            if self.trace is not None:
                self.trace.record(INST_FIRST_SERVICE, ts=t, a=job_id)

    def job_complete(
        self, t: int, job_id: int, arrival: int, jct: int, n_tasks: int
    ) -> None:
        self.metrics.inc("jobs.completed")
        self.metrics.observe("jobs.jct_slots", jct)
        if self.trace is not None:
            self.trace.record(
                SPAN_JOB, ts=arrival, dur=jct, a=job_id, c=n_tasks
            )

    def job_failed(self, t: int, job_id: int) -> None:
        self.metrics.inc("jobs.failed")
        if self.trace is not None:
            self.trace.record(INST_FAILED, ts=t, a=job_id)

    # admission / retry outcomes are counters only — no trace kind, so
    # existing trace consumers and the chrome export stay untouched
    def job_deferred(self, t: int, job_id: int) -> None:
        self.metrics.inc("jobs.deferred")

    def job_shed(self, t: int, job_id: int) -> None:
        self.metrics.inc("jobs.shed")

    def job_retry(self, t: int, job_id: int) -> None:
        self.metrics.inc("jobs.retried")

    # ---- control-plane phases -------------------------------------------

    def tick_phase(self, name: str, t0: float) -> None:
        """Close a host-time phase span opened at ``t0`` (a
        :meth:`DeviceProfiler.start`-style ``perf_counter`` reading)."""
        wall_us = clock.us_since(t0)
        self.metrics.observe(f"tick.{name}.us", wall_us)
        if self.trace is not None:
            self.trace.record(
                SPAN_TICK,
                ts=self.host_us(t0),
                dur=wall_us,
                a=self.trace.intern(name),
            )

    # ---- stealing / speculation / reassignment ---------------------------

    def steal_attempt(self, t: int, thief: int) -> None:
        self.metrics.inc("steal.attempted")

    def steal(
        self, t: int, job_id: int, donor: int, thief: int, tasks: int
    ) -> None:
        self.metrics.inc("steal.won")
        self.metrics.observe("steal.tasks", tasks)
        if self.trace is not None:
            self.trace.record(
                INST_STEAL,
                ts=t,
                dur=thief,
                a=job_id,
                b=donor,
                c=tasks,
                link=self._next_flow(),
            )

    def spec_launch(self, t: int, job_id: int, src: int, dst: int) -> int:
        """Record a speculative-clone launch; returns the causality link
        id the matching :meth:`spec_resolve` must echo."""
        self.metrics.inc("spec.launched")
        link = self._next_flow()
        if self.trace is not None:
            self.trace.record(
                INST_SPEC_LAUNCH, ts=t, a=job_id, b=src, c=dst, link=link
            )
        return link

    def spec_resolve(
        self, t: int, job_id: int, outcome: int, tasks: int, link: int
    ) -> None:
        name = {
            SPEC_ORIGINAL_WON: "spec.won_original",
            SPEC_CLONE_WON: "spec.won_clone",
        }.get(outcome, "spec.aborted")
        self.metrics.inc(name)
        if self.trace is not None:
            self.trace.record(
                INST_SPEC_RESOLVE,
                ts=t,
                a=job_id,
                b=outcome,
                c=tasks,
                link=link,
            )

    def reassign(self, t: int, job_id: int, tasks: int) -> None:
        self.metrics.inc("reassign.events")
        self.metrics.inc("reassign.tasks", tasks)
        if self.trace is not None:
            self.trace.record(INST_REASSIGN, ts=t, a=job_id, c=tasks)

    # ---- queue / placement -----------------------------------------------

    def enqueued(self, job, server: int, per_group: dict[int, int]) -> None:
        """Locality-tier accounting for one enqueued segment: replica
        rank 0 means ``server`` is the group's first-listed replica
        holder; higher ranks are secondary replicas.  Placement outside
        the locality set cannot happen (cluster invariant), so two tiers
        cover the space."""
        rank0 = other = 0
        for g, cnt in per_group.items():
            servers = job.groups[g].servers
            if servers and server == servers[0]:
                rank0 += cnt
            else:
                other += cnt
        if rank0:
            self.metrics.inc("locality.rank0_tasks", rank0)
        if other:
            self.metrics.inc("locality.secondary_tasks", other)

    def placement_event(self, t: int, kind: str, block: str, server: int) -> None:
        self.metrics.inc(f"placement.{kind}")
        if self.trace is not None:
            self.trace.record(
                INST_PLACEMENT,
                ts=t,
                a=self.trace.intern(f"{kind}:{block}"),
                b=server,
            )

    # ---- serving ---------------------------------------------------------

    def serve_request(self, t: int, rid: int, tokens: int) -> None:
        self.metrics.inc("serve.requests")
        self._serve_submit[rid] = (t, tokens)

    def serve_done(self, t_done: int, rid: int, latency: int) -> None:
        self.metrics.inc("serve.completed")
        self.metrics.observe("serve.latency_slots", latency)
        submit, tokens = self._serve_submit.pop(rid, (t_done - latency, 0))
        if self.trace is not None:
            self.trace.record(
                SPAN_SERVE, ts=submit, dur=latency, a=rid, c=tokens
            )

    def serve_routed(self, n_replicas: int) -> None:
        self.metrics.inc("serve.routed")
        self.metrics.observe("serve.fanout", n_replicas)

    # ---- per-tick snapshots ----------------------------------------------

    def snapshot(self, t: int, cluster) -> None:
        """Capture queue-depth and eq. 2 gauges at most once per
        ``metrics_every`` ticks.  Reads only (``busy_times`` may fill the
        incremental cache — bit-identical to the lazy fill by the rescan
        invariant)."""
        if self._last_snap is not None and t - self._last_snap < self.metrics_every:
            return
        self._last_snap = t
        m = self.metrics
        depths = [len(q) for q in cluster.queues]
        busy = cluster.busy_times()
        m.set_gauge("queue.segments", float(sum(depths)))
        m.set_gauge("queue.max_depth", float(max(depths, default=0)))
        m.set_gauge("busy.max", float(busy.max()) if busy.size else 0.0)
        m.set_gauge("busy.mean", float(busy.mean()) if busy.size else 0.0)
        m.set_gauge("jobs.live", float(len(cluster.remaining)))
        m.snapshot(t)


# ---- ambient activation --------------------------------------------------

_ACTIVE: list[ObsSession] = []


def active() -> ObsSession | None:
    """The innermost active session, or None when observability is off."""
    return _ACTIVE[-1] if _ACTIVE else None


def device_profiler() -> DeviceProfiler | None:
    """The active session's device profiler (None when off — the adapter
    hot paths guard on this and skip all timing)."""
    return _ACTIVE[-1].device if _ACTIVE else None


@contextlib.contextmanager
def observe(
    *,
    trace: bool = True,
    trace_capacity: int = 1 << 16,
    metrics_every: int = 1,
    device: bool = True,
) -> Iterator[ObsSession]:
    """Scope an :class:`ObsSession` as the ambient session::

        with obs.observe() as session:
            result = ControlPlane(scenario="bursty").drain()

    Nests like :func:`repro_torch.backend.set_backend`; the innermost session
    wins.  Layers constructed inside the scope bind the session at
    construction, so the session outlives the ``with`` for export."""
    session = ObsSession(
        trace=trace,
        trace_capacity=trace_capacity,
        metrics_every=metrics_every,
        device=device,
    )
    _ACTIVE.append(session)
    try:
        yield session
    finally:
        _ACTIVE.pop()
