"""Event-stepped control plane over the slot-exact scheduling engine.

The port's copy of ``repro/runtime/loop.py``, observability hooks
included: each emits what the reference's emits, in the same order, so
a trace of the port equals the reference's record for record.
:class:`ControlPlane`
replaces the slot-stepped ``while`` loop with a
priority event queue: job arrivals, service ticks, server fault events,
placement churn, serve-request routing, and heartbeats all ride one
timeline, popped in ``(time, priority)`` order.  Idle stretches cost
nothing — service ticks only self-schedule while some queue is non-empty
— and jobs/requests can be submitted *while* the simulation runs
(:meth:`submit` + :meth:`step_until`), which the closed ``run(jobs)``
API cannot express.

Within one slot ``t`` the pop order reproduces the slot loop exactly:

1. cluster/placement events due at ``t`` (``_P_EVENT``),
2. the arrival burst at ``t``, sorted by job id (``_P_ARRIVAL``),
3. serve-request routing (``_P_REQUEST``; no slot-loop counterpart),
4. the service tick — one :meth:`ClusterState.process_slot`
   (``_P_SERVICE``),
5. heartbeats — router/serve-pool drains (``_P_HEARTBEAT``).

so with stealing and speculation off, :meth:`drain` is
schedule-identical to ``SchedulingEngine.run`` on the same trace
(equivalence-tested across registered scenarios): same JCTs, same
makespan, same failed set, same reassignment count.  Leftover timeline
events after the last arrival has completed are dropped, exactly as the
slot loop's termination drops them.

Four *online* mechanisms exist only here (they need idle-edge timing the
slot loop never observes); their thresholds all live in
:class:`repro_torch.runtime.resilience.ResilienceConfig` (reprolint R009):

- **cost-based work-stealing** (``stealing=True``): when a server's
  queue runs dry, it pulls locality-eligible tail fragments from a
  backlogged donor until ~half the donor's eq. 2 backlog cost has moved
  (dask-style half-split), re-placing each affected job jointly through
  the policy — the fail path's merge-fragments-per-job machinery on the
  idle edge, with the eq. 2 busy vector delta-corrected on both sides.
  Steals below ``steal_min_gain`` are rejected, and donors that keep
  yielding nothing are backed off exponentially.
- **budgeted speculation** (``speculation=True``): a head fragment whose
  completion estimate under this server's *observed* service rate (a
  per-server EWMA of tasks completed per tick) is ``spec_factor``×
  worse than under the best observed peer on the same job (or the clone
  target's nominal rate) is cloned onto an idle, fully-eligible server; both copies run under
  shadow job ids, the job is credited ``max`` cumulative progress
  (never the sum — losers contribute no eq. 2 credit), and the first
  copy to finish cancels the other with a busy-time delta-correction.
  Concurrent pairs are capped by a global budget (adapted from the
  observed clone win rate) plus a per-job launch quota.
- **admission control** (``ResilienceConfig(admission=True)``): when the
  max eq. 2 backlog exceeds ``lag_defer_budget`` slots, new arrivals
  wait in a bounded pending queue; past ``lag_shed_budget`` (or a full
  queue) they are shed — recorded on ``SimResult.shed_jobs`` — which
  keeps the event heap bounded under sustained overload (ρ > 1).
- **retry-with-backoff** (``ResilienceConfig(retry=True)``): a job
  whose stranded fragment has no live replica left (server or rack
  failure) parks the fragment and retries placement after an
  exponential backoff instead of failing immediately, up to
  ``retry_limit`` attempts.

Serve traffic shares the timeline: :meth:`submit_request` routes token
batches through a :class:`repro_torch.serve.engine.ReplicaRouter` (or a full
``serve_pool`` of decode engines) whose eligible sets resolve from the
*live* placement store — the same store cluster placement events mutate.

Every assignment the plane makes — arrivals, fault reassignment, steals,
retries — goes through the engine's policy, so with ``wf_torch`` or
``rd_torch`` (``rd_plus``) each one runs on the card.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Callable

from .. import registry
from ..analysis import runtime as sanitizers
from ..core import Job
from ..obs import clock
from ..obs.session import (
    SPEC_ABORTED,
    ObsSession,
    active as obs_active,
)
from ..placement import PlacementEvent, PlacementStore

from .cluster import ClusterState, QueueSegment
from .engine import SchedulingEngine, SimResult
from .events import RackEvent, ServerEvent
from .policies import Policy, SchedulingPolicy, make_policy
from .resilience import ResilienceConfig, ResilienceState

__all__ = ["ControlPlane"]

# pop order within one slot; the slot loop's phases, in its order
_P_EVENT = 0  # server fault / placement churn
_P_ARRIVAL = 1  # job arrival burst
_P_REQUEST = 2  # serve-request routing
_P_SERVICE = 3  # one ClusterState.process_slot
_P_HEARTBEAT = 4  # router / serve-pool drain

# tick-phase names for obs spans, indexed by priority
_PHASE_NAMES = ("event", "arrival", "request", "service", "heartbeat")


@dataclasses.dataclass(frozen=True)
class _Retry:
    """Timeline payload: re-attempt placement of a parked job's stranded
    fragment (data-loss retry-with-backoff)."""

    job_id: int


@dataclasses.dataclass
class _SpecPair:
    """One straggler fragment running as two shadow copies."""

    job_id: int
    size: int  # tasks in the fragment at launch
    copies: list[tuple[int, QueueSegment, int]]  # (server, seg, shadow id)
    done: list[int]  # cumulative tasks per copy
    credited: int = 0  # progress already credited to the real job
    obs_link: int = 0  # trace causality id binding launch to resolution


class ControlPlane:
    """Event-stepped scheduler: ``submit`` jobs, ``step_until`` a time,
    or ``drain`` to completion.

    ``policy``/``ordering``/``scenario`` resolve by registered name
    (:mod:`repro_torch.registry`), so ``ControlPlane(policy="rd_plus",
    ordering="setf", scenario="bursty")`` is a complete configuration:
    the scenario's jobs are generated and submitted at construction and
    ``n_servers`` defaults to the scenario config's.
    """

    def __init__(
        self,
        n_servers: int | None = None,
        policy: SchedulingPolicy | Policy | str = "wf",
        ordering: str = "fifo",
        *,
        scenario: str | None = None,
        scenario_kw: dict | None = None,
        events: tuple[ServerEvent | RackEvent | PlacementEvent, ...] = (),
        placement: PlacementStore | None = None,
        router=None,
        serve_pool=None,
        stealing: bool = False,
        speculation: bool = False,
        spec_factor: float | None = None,
        resilience: ResilienceConfig | None = None,
        max_slots: int = 10_000_000,
        on_slot: Callable[[ClusterState, int], None] | None = None,
        on_complete: Callable[[int, int], None] | None = None,
        on_heartbeat: Callable[[int], None] | None = None,
        debug: bool = False,
        batch_arrivals: bool = True,
        obs: ObsSession | None = None,
    ):
        scenario_jobs: list[Job] = []
        if scenario is not None:
            from .. import traces  # noqa: F401  (registers the scenarios)

            cfg_cls, gen = registry.resolve("scenario", scenario)
            cfg = cfg_cls(**(scenario_kw or {}))
            scenario_jobs = gen(cfg, store=placement)
            if n_servers is None:
                n_servers = cfg.n_servers
        elif scenario_kw:
            raise ValueError("scenario_kw without scenario=")
        if n_servers is None:
            raise ValueError("need n_servers= (or a scenario= to take it from)")
        if isinstance(policy, str):
            policy = make_policy(policy, ordering)
        events = tuple(sorted(events, key=lambda e: e.slot))
        if placement is None and any(
            isinstance(e, PlacementEvent) for e in events
        ):
            raise ValueError("placement events require a placement store")
        # process-wide sanitizers (repro_torch.analysis.runtime.enable)
        # behave exactly like debug=True
        debug = debug or sanitizers.enabled()
        self.debug = debug
        self.obs = obs if obs is not None else obs_active()
        # the engine is used for its admission / fault / placement
        # machinery only — the plane owns time, so the engine gets no
        # timeline of its own and its slot loop is never entered
        self.engine = SchedulingEngine(
            n_servers,
            policy,
            placement=placement,
            max_slots=max_slots,
            debug=debug,
            batch_arrivals=batch_arrivals,
            obs=self.obs,
        )
        self.engine.cluster = ClusterState(
            n_servers, {}, debug=debug, obs=self.obs
        )
        self.n_servers = n_servers
        self.stealing = stealing
        self.speculation = speculation
        cfg = resilience if resilience is not None else ResilienceConfig()
        if spec_factor is not None:  # legacy knob folds into the config
            cfg = dataclasses.replace(cfg, spec_factor=spec_factor)
        self.resilience = cfg
        # feedback state only exists when some mechanism can consult it,
        # keeping the default (all-off) path allocation-free
        self._res: ResilienceState | None = (
            ResilienceState(cfg, n_servers)
            if cfg.needs_state(stealing, speculation)
            else None
        )
        if cfg.retry:
            self.engine.on_data_loss = self._park_for_retry
        self.max_slots = max_slots
        self.on_slot = on_slot
        self.on_complete = on_complete
        self.on_heartbeat = on_heartbeat
        self.serve_pool = serve_pool
        self.router = serve_pool.router if serve_pool is not None else router

        self._heap: list[tuple[int, int, int, object]] = []
        self._seq = 0
        self._now = 0
        self._makespan = 0
        self._pending_arrivals = 0
        self._pending_requests = 0
        self._service_at: int | None = None
        self._heartbeat_pending = False
        self.jct: dict[int, int] = {}
        self.overheads: list[float] = []
        self.serve_latency: dict[int, int] = {}
        self._submit_t: dict[int, int] = {}
        self._rid = 0
        self.steals = 0
        self.speculations = 0
        self.spec_cancels = 0
        self.retries = 0
        self.dropped_events = 0
        self.heap_peak = 0
        self._pairs: list[_SpecPair] = []
        self._specs: dict[int, tuple[_SpecPair, int]] = {}  # shadow id -> (pair, copy)
        self._spec_jobs: set[int] = set()  # real ids with a live pair
        self._shadow_seq = 0

        for ev in events:
            self._push(max(ev.slot, 0), _P_EVENT, ev)
        self.submit_many(scenario_jobs)

    # ---- public API ------------------------------------------------------

    @property
    def now(self) -> int:
        """Time (slot) through which the plane has processed."""
        return self._now

    def submit(self, job: Job) -> int:
        """Enqueue one job; returns its effective arrival slot (a job
        submitted after its nominal arrival has passed arrives *now* —
        its JCT still counts from the nominal arrival)."""
        t = max(job.arrival, 0, self._now)
        cluster = self.engine.cluster
        cluster.jobs[job.job_id] = job
        if job.n_tasks > 0:
            cluster.remaining[job.job_id] = job.n_tasks
        self._push(t, _P_ARRIVAL, job)
        self._pending_arrivals += 1
        if self.obs is not None:
            self.obs.job_arrival(t, job.job_id, job.n_tasks)
        return t

    def submit_many(self, jobs: list[Job]) -> None:
        for job in jobs:
            self.submit(job)

    def submit_request(
        self,
        n_tokens: int = 0,
        *,
        at: int | None = None,
        model: str | None = None,
        adapter: str | None = None,
        eligible: tuple[int, ...] | None = None,
        request=None,
    ) -> int:
        """Enqueue a serve request for routing at slot ``at`` (default:
        now).  With a bare ``router``, ``n_tokens`` of decode work are
        placed by eq. 2 and the latency recorded analytically; with a
        ``serve_pool``, ``request`` (a :class:`repro_torch.serve.engine.
        Request`) is admitted to the routed replica's decode batch and
        its latency recorded when the heartbeat drain finishes it.
        Returns the request id."""
        if self.router is None and self.serve_pool is None:
            raise ValueError("serve requests need router= or serve_pool=")
        if request is not None:
            rid = request.request_id
        else:
            rid = self._rid
            self._rid += 1
        t = max(at if at is not None else self._now, self._now)
        self._push(t, _P_REQUEST, (rid, n_tokens, model, adapter, eligible, request))
        self._pending_requests += 1
        return rid

    def step_until(self, t: int) -> None:
        """Process every queued occurrence through slot ``t`` inclusive.

        Live-mode semantics: events always apply (the cluster exists
        continuously), unlike :meth:`drain`, which reproduces the slot
        loop's drop-after-termination behavior for finite traces."""
        while self._heap and self._heap[0][0] <= t:
            self._pop_next()
        self._now = max(self._now, t)

    def drain(self) -> SimResult:
        """Run to quiescence and return the :class:`SimResult`.

        Timeline events due after the last pending work has finished are
        dropped (counted in :attr:`dropped_events`), matching the slot
        loop's termination check exactly."""
        while self._heap:
            if not self._has_pending_work():
                self.dropped_events += sum(
                    1 for e in self._heap if e[1] == _P_EVENT
                )
                self._heap.clear()
                break
            self._pop_next()
        return self.result()

    def result(self) -> SimResult:
        cluster = self.engine.cluster
        st = self._res
        return SimResult(
            jct=self.jct,
            overhead_s=self.overheads,
            makespan=self._makespan,
            failed_jobs=cluster.failed,
            reassignments=cluster.reassigned,
            steals=self.steals,
            speculations=self.speculations,
            spec_cancels=self.spec_cancels,
            serve_latency=self.serve_latency,
            inflight_requests=len(self._submit_t),
            shed_jobs=dict(st.shed) if st is not None else {},
            deferred_peak=st.deferred_peak if st is not None else 0,
            retries=self.retries,
            heap_peak=self.heap_peak,
        )

    # ---- event queue -----------------------------------------------------

    def _push(self, t: int, prio: int, payload) -> None:
        heapq.heappush(self._heap, (t, prio, self._seq, payload))
        self._seq += 1
        if len(self._heap) > self.heap_peak:
            self.heap_peak = len(self._heap)

    def _has_pending_work(self) -> bool:
        return (
            self._pending_arrivals > 0
            or self._pending_requests > 0
            or bool(self.engine.cluster.remaining)
            or self._serve_busy()
        )

    def _pop_next(self) -> None:
        t, prio, _, payload = heapq.heappop(self._heap)
        self._now = max(self._now, t)
        o = self.obs
        if o is not None:
            o.sim_now = t
            t0 = clock.perf_counter()
        if prio == _P_EVENT:
            self._handle_cluster_event(t, payload)
        elif prio == _P_ARRIVAL:
            batch = [payload]
            while self._heap and self._heap[0][:2] == (t, _P_ARRIVAL):
                batch.append(heapq.heappop(self._heap)[3])
            self._handle_arrivals(t, batch)
        elif prio == _P_REQUEST:
            self._handle_request(t, payload)
        elif prio == _P_SERVICE:
            self._service_at = None
            self._handle_service(t)
        else:
            self._heartbeat_pending = False
            self._handle_heartbeat(t)
        if o is not None:
            o.tick_phase(_PHASE_NAMES[prio], t0)

    def _ensure_service(self, t: int) -> None:
        if self._service_at is None:
            self._push(t, _P_SERVICE, None)
            self._service_at = t

    def _ensure_heartbeat(self, t: int) -> None:
        if not self._heartbeat_pending:
            self._push(t, _P_HEARTBEAT, None)
            self._heartbeat_pending = True

    # ---- handlers --------------------------------------------------------

    def _handle_cluster_event(self, t: int, ev) -> None:
        # shadow copies would leak through fail/evict stranding and
        # reorder rescans — fold every pair back to its real job first
        self._cancel_all_specs()
        self._makespan = max(self._makespan, t + 1)
        if isinstance(ev, _Retry):
            self._retry_fire(t, ev.job_id)
        elif isinstance(ev, PlacementEvent):
            self.engine._apply_placement_event(ev)
        else:
            self.engine._apply_event(ev)

    def _handle_arrivals(self, t: int, jobs: list[Job]) -> None:
        if self.engine.policy.reorders:
            self._cancel_all_specs()
        self._pending_arrivals -= len(jobs)
        self._makespan = max(self._makespan, t + 1)
        # burst order matches the slot loop's (arrival, job_id) sort
        jobs.sort(key=lambda j: (j.arrival, j.job_id))
        batch: list[Job] = []
        for job in jobs:
            if job.n_tasks == 0:
                self.jct[job.job_id] = 0  # empty job completes at arrival
                if self.obs is not None:
                    self.obs.job_complete(t, job.job_id, job.arrival, 0, 0)
                if self.on_complete is not None:
                    self.on_complete(job.job_id, 0)
                continue
            batch.append(job)
        if self.resilience.admission and batch:
            batch = self._admission_filter(t, batch)
        if batch:
            self.overheads.extend(self.engine._admit_burst(batch))
            self._ensure_service(t)
        elif self._res is not None and self._res.deferred:
            self._ensure_service(t)  # keep the drain loop ticking

    def _handle_request(self, t: int, payload) -> None:
        rid, n_tokens, model, adapter, eligible, request = payload
        self._pending_requests -= 1
        if self.obs is not None:
            self.obs.serve_request(t, rid, n_tokens)
        if self.serve_pool is not None and request is not None:
            self.serve_pool.submit(
                request, model=model, adapter=adapter, eligible=eligible
            )
            self._submit_t[rid] = t
        else:
            out = self.router.route(
                n_tokens, eligible, model=model, adapter=adapter
            )
            # the request's tokens are last in each replica's queue: it
            # finishes when the slowest routed replica drains (eq. 2)
            latency = max(
                -(-int(self.router.queued[m]) // int(self.router.rate[m]))
                for m in out
            )
            self.serve_latency[rid] = latency
            if self.obs is not None:
                self.obs.serve_done(t + latency, rid, latency)
        self._ensure_heartbeat(t + 1)

    def _handle_service(self, t: int) -> None:
        if t >= self.max_slots:
            raise RuntimeError("simulation exceeded max_slots — livelock?")
        if self.debug:
            # every tick: (t, prio, seq) keys must stay a unique,
            # comparable total order with the heap property intact
            sanitizers.check_event_heap(self._heap)
        cluster = self.engine.cluster
        st = self._res
        if st is not None and self.resilience.admission and st.deferred:
            self._admit_deferred(t)
        if self.stealing:
            self._steal_scan()
        done: dict[int, int] = {}
        for job_id, n in cluster.process_slot().items():
            if job_id < 0:  # shadow copy: accumulate on its pair
                pair, ci = self._specs[job_id]
                pair.done[ci] += n
            else:
                done[job_id] = done.get(job_id, 0) + n
        if st is not None and self.speculation:
            st.observe_service(cluster)  # rate EWMAs for straggler detection
        for pair in list(self._pairs):
            adv = max(pair.done)
            if adv > pair.credited:  # credit = best copy's delta, never the sum
                done[pair.job_id] = done.get(pair.job_id, 0) + adv - pair.credited
                pair.credited = adv
            if adv >= pair.size:  # first finisher wins; cancel the other
                self._close_pair(pair)
        o = self.obs
        for job_id, n_done in done.items():
            if job_id not in cluster.remaining:
                continue
            if o is not None:
                o.service_progress(t, job_id, n_done)
            cluster.remaining[job_id] -= n_done
            if cluster.remaining[job_id] <= 0:
                job = cluster.jobs[job_id]
                jct = t + 1 - job.arrival
                self.jct[job_id] = jct
                del cluster.remaining[job_id]
                if o is not None:
                    o.job_complete(t, job_id, job.arrival, jct, job.n_tasks)
                if self.on_complete is not None:
                    self.on_complete(job_id, jct)
        if self.on_slot is not None:
            self.on_slot(cluster, t)
        self._makespan = max(self._makespan, t + 1)
        if self.speculation:
            self._spec_scan()
        if o is not None:
            o.snapshot(t, cluster)
        if any(cluster.queues) or (st is not None and st.deferred):
            self._ensure_service(t + 1)

    def _handle_heartbeat(self, t: int) -> None:
        if self.serve_pool is not None:
            for req in self.serve_pool.step():
                rid = req.request_id
                if rid in self._submit_t:
                    latency = t + 1 - self._submit_t.pop(rid)
                    self.serve_latency[rid] = latency
                    if self.obs is not None:
                        self.obs.serve_done(t + 1, rid, latency)
        elif self.router is not None:
            self.router.drain()
        if self.on_heartbeat is not None:
            self.on_heartbeat(t)
        if self._serve_busy():
            self._ensure_heartbeat(t + 1)

    def _serve_busy(self) -> bool:
        if self.serve_pool is not None:
            return self.serve_pool.busy()
        return self.router is not None and bool(self.router.queued.any())

    # ---- work-stealing ---------------------------------------------------

    def _steal_scan(self) -> None:
        """Each idle server pulls one job's eligible tail fragments from
        the most backlogged donor and re-places them through the policy —
        the fail path's merge-and-reassign machinery, on the idle edge."""
        cluster = self.engine.cluster
        idle = [
            m
            for m in range(self.n_servers)
            if cluster.alive[m] and not cluster.queues[m]
        ]
        if not idle:
            return
        busy = cluster.busy_times()
        donors = sorted(
            (p for p in range(self.n_servers) if len(cluster.queues[p]) >= 2),
            key=lambda p: (-busy[p], p),
        )
        # The reference walks every donor's tail for every idle server; at
        # thousands of servers that walk dominates the tick.  A donor
        # whose stealable tail holds no fragment eligible on m yields an
        # empty plan and is skipped with no side effect, so m walks only
        # the donors (in donor order) that can give it work: the same
        # steals, misses and order.  A steal enqueues on other servers
        # (their tails grow), so it rebuilds the index.
        thieves: dict[int, list[int]] | None = None
        for m in idle:
            if cluster.queues[m]:  # an earlier steal already landed here
                continue
            if self.obs is not None:
                # the reference counts an attempt for every idle server
                # it walks, whether or not a donor can give it work
                self.obs.steal_attempt(self._now, m)
            if thieves is None:
                thieves = self._thief_index(donors)
            sources = thieves.get(m)
            if sources and self._steal_for(m, sources):
                busy = cluster.busy_times()
                donors.sort(key=lambda p: (-busy[p], p))
                thieves = None

    def _thief_index(self, donors: list[int]) -> dict[int, list[int]]:
        """server -> the donors, in ``donors`` order, with a stealable tail
        segment (past the head, no shadow copy) eligible on it."""
        cluster = self.engine.cluster
        out: dict[int, list[int]] = {}
        for p in donors:
            q = cluster.queues[p]
            if len(q) < 2:
                continue
            reach: dict[int, None] = {}
            for seg in list(q)[1:]:
                if seg.job_id >= 0:
                    groups = cluster.jobs[seg.job_id].groups
                    for g in seg.per_group:
                        reach.update(dict.fromkeys(groups[g].servers))
            for server in reach:
                out.setdefault(server, []).append(p)
        return out

    def _steal_for(self, m: int, donors: list[int]) -> bool:
        """Pull locality-eligible tail fragments from the first ready
        donor until ~half its eq. 2 backlog cost has moved (dask-style
        half-split), then re-place each affected job jointly — the fail
        path's merge-per-job machinery on the idle edge.  Donors whose
        eligible tail is worth less than ``steal_min_gain`` count as a
        miss and back off exponentially."""
        cluster = self.engine.cluster
        st = self._res
        cfg = self.resilience
        busy = cluster.busy_times()
        for p in donors:
            if not st.steal_ready(p, self._now):
                continue
            q = list(cluster.queues[p])
            if len(q) < 2:
                continue
            # tail-first; the head is in service and shadow copies are
            # pinned to their server, so neither is stealable
            target = int(busy[p]) // 2
            plan: list[tuple[QueueSegment, list[int]]] = []
            planned = 0
            for seg in reversed(q[1:]):
                if seg.job_id < 0:
                    continue
                job = cluster.jobs[seg.job_id]
                gids = [g for g in seg.per_group if m in job.groups[g].servers]
                if not gids:
                    continue
                mu = int(cluster.effective_mu(job)[p])
                pulled = sum(seg.per_group[g] for g in gids)
                # donor-side eq. 2 slots this pull frees (ceil deltas)
                gain = -(-seg.total // mu) - -(-(seg.total - pulled) // mu)
                plan.append((seg, gids))
                planned += gain
                if planned >= target:
                    break
            if not plan:
                # thief-specific ineligibility says nothing about the
                # donor — skip silently, no backoff
                continue
            if planned < cfg.steal_min_gain:
                st.steal_missed(p, self._now)
                continue
            # merge the pulls per job (insertion order) so the policy
            # balances each job's moved tasks jointly
            merged: dict[int, dict[int, int]] = {}
            for seg, gids in plan:
                per = merged.setdefault(seg.job_id, {})
                for g, cnt in cluster.pull_from_segment(p, seg, gids).items():
                    per[g] = per.get(g, 0) + cnt
            moved = 0
            for job_id, per_group in merged.items():
                job = cluster.jobs[job_id]
                proj = cluster.project(job, per_group)
                assert proj is not None  # m is alive and eligible per gid
                groups, gids = proj
                prob = cluster.problem_for(job, groups)
                assignment = self.engine.policy.assign(prob)
                if self.engine.debug:
                    assignment.validate(prob)
                cluster.enqueue(job_id, assignment, gids)
                n = sum(per_group.values())
                moved += n
                if self.obs is not None:
                    self.obs.steal(self._now, job_id, p, m, n)
            self.steals += moved
            st.steal_won(p)
            st.metrics.inc("steal.moved_cost", planned)
            return True
        return False

    # ---- speculative replication -----------------------------------------

    def _spec_scan(self) -> None:
        """Clone straggling head fragments onto idle, fully-eligible
        servers; both copies run under shadow ids until one finishes.

        Detection is *progress-based*: a head fragment is a straggler
        when this server's observed service-rate EWMA lags the best peer
        serving the same job by ``spec_factor``× — not when the static
        mu table says it should be slow.  Launches are bounded by the
        adaptive global pair budget and a per-job lifetime quota."""
        cluster = self.engine.cluster
        st = self._res
        cfg = self.resilience
        budget = st.adapted_spec_budget()
        if len(self._pairs) >= budget:
            return
        idle = [
            m
            for m in range(self.n_servers)
            if cluster.alive[m] and not cluster.queues[m]
        ]
        if not idle:
            return
        idle_set = set(idle)
        # job -> servers currently holding one of its head fragments
        serving: dict[int, list[int]] = {}
        for p in range(self.n_servers):
            if cluster.alive[p] and cluster.queues[p]:
                j = cluster.queues[p][0].job_id
                if j >= 0:
                    serving.setdefault(j, []).append(p)
        for m in range(self.n_servers):
            if not idle or len(self._pairs) >= budget:
                return
            if not cluster.alive[m] or not cluster.queues[m]:
                continue
            seg = cluster.queues[m][0]
            j = seg.job_id
            if j < 0 or j in self._spec_jobs:
                continue
            if st.spec_launched.get(j, 0) >= cfg.spec_job_quota:
                continue
            # need a stable rate observation on exactly this head first
            if (
                int(st.head_streak[m]) < cfg.spec_detect_window
                or int(st.head_job[m]) != j
            ):
                continue
            job = cluster.jobs[j]
            # the clone carries the whole fragment, so the target must be
            # in EVERY constituent group's locality set; the best target
            # is the least (-mu, id) among the idle ones — the reference
            # scans every idle server for it, here the locality sets'
            # intersection is scanned instead (same target)
            eligible = idle_set.intersection(
                *(job.groups[g].servers for g in seg.per_group)
            )
            if not eligible:
                continue
            mu = cluster.effective_mu(job)
            best = min(eligible, key=lambda i: (-int(mu[i]), i))
            best_mu = int(mu[best])
            rate_here = float(st.rate[m])
            peers = [
                p
                for p in serving.get(j, ())
                if p != m and st.head_streak[p] > 0
            ]
            # reference speed: the best observed peer on the same job, or
            # the clone target's nominal rate when no peer was measured
            ref_rate = max(
                max((float(st.rate[p]) for p in peers), default=0.0),
                float(best_mu),
            )
            # straggler test on *completion estimates* from observed
            # rates (ceil granularity matters: a 2-slot head vs a 1-slot
            # clone is already a 2x straggler)
            est_here = -(-seg.total // max(int(rate_here), 1))
            est_ref = -(-seg.total // max(int(ref_rate), 1))
            if est_here < cfg.spec_factor * est_ref or est_here - est_ref < 1:
                continue
            self._launch_spec(m, seg, best)
            st.spec_launched[j] = st.spec_launched.get(j, 0) + 1
            idle.remove(best)
            idle_set.discard(best)

    def _launch_spec(self, m: int, seg: QueueSegment, target: int) -> None:
        cluster = self.engine.cluster
        job = cluster.jobs[seg.job_id]
        shadow_a = -1 - 2 * self._shadow_seq
        shadow_b = -2 - 2 * self._shadow_seq
        self._shadow_seq += 1
        # same mu, so relabeling leaves every segment cost unchanged —
        # the incremental eq. 2 vector needs no correction here
        cluster.jobs[shadow_a] = dataclasses.replace(job, job_id=shadow_a)
        cluster.jobs[shadow_b] = dataclasses.replace(job, job_id=shadow_b)
        pair = _SpecPair(
            job_id=seg.job_id,
            size=seg.total,
            copies=[],
            done=[0, 0],
        )
        seg.job_id = shadow_a
        clone = QueueSegment(shadow_b, dict(seg.per_group))
        cluster.adopt_segment(target, clone)
        pair.copies = [(m, seg, shadow_a), (target, clone, shadow_b)]
        self._pairs.append(pair)
        self._specs[shadow_a] = (pair, 0)
        self._specs[shadow_b] = (pair, 1)
        self._spec_jobs.add(pair.job_id)
        self.speculations += 1
        if self.obs is not None:
            pair.obs_link = self.obs.spec_launch(
                self._now, pair.job_id, m, target
            )

    def _close_pair(self, pair: _SpecPair) -> None:
        """First-finisher-wins resolution: cancel the laggard copy (its
        remaining tasks leave the queue with a busy delta-correction) and
        fold the survivor back to the real job id."""
        cluster = self.engine.cluster
        winner = 0 if pair.done[0] >= pair.done[1] else 1
        finished = max(pair.done) >= pair.size
        if self._res is not None:
            # mirrored into the PRIVATE registry: budget adaptation reads
            # these back, so they must exist whatever observes the run
            self._res.record_spec_outcome(
                "spec.aborted"
                if not finished
                else ("spec.won_original" if winner == 0 else "spec.won_clone")
            )
        if self.obs is not None:
            outcome = winner if finished else SPEC_ABORTED
            self.obs.spec_resolve(
                self._now, pair.job_id, outcome, max(pair.done), pair.obs_link
            )
        for ci, (server, seg, shadow) in enumerate(pair.copies):
            if seg.total > 0:
                if ci == winner:
                    seg.job_id = pair.job_id  # fold back; cost unchanged
                else:
                    cluster.remove_segment(server, seg)
                    self.spec_cancels += 1
            cluster.jobs.pop(shadow, None)
            cluster._mu_cache.pop(shadow, None)
            self._specs.pop(shadow, None)
        self._pairs.remove(pair)
        self._spec_jobs.discard(pair.job_id)

    def _cancel_all_specs(self) -> None:
        """Fold every live pair back to its real job before fault /
        placement / reorder machinery walks the queues (those paths key
        on real job ids and must not see shadow segments)."""
        cluster = self.engine.cluster
        for pair in list(self._pairs):
            adv = max(pair.done)
            if adv > pair.credited and pair.job_id in cluster.remaining:
                cluster.remaining[pair.job_id] -= adv - pair.credited
                pair.credited = adv
            self._close_pair(pair)

    # ---- admission control / load shedding -------------------------------

    def _admission_filter(self, t: int, batch: list[Job]) -> list[Job]:
        """Defer (or shed) arrivals while the eq. 2 backlog is past its
        lag budgets.  Returns the sub-batch to admit immediately — all of
        it on the healthy fast path, none of it once deferral starts
        (later arrivals must queue behind already-deferred jobs)."""
        cluster = self.engine.cluster
        st = self._res
        cfg = self.resilience
        lag = int(cluster.busy_times().max())
        if lag <= cfg.lag_defer_budget and not st.deferred:
            return batch
        for job in batch:
            if (
                lag > cfg.lag_shed_budget
                or len(st.deferred) >= cfg.defer_queue_cap
            ):
                self._shed(t, job)
            else:
                st.deferred.append(job)
                st.metrics.inc("admit.deferred")
                if self.obs is not None:
                    self.obs.job_deferred(t, job.job_id)
        if len(st.deferred) > st.deferred_peak:
            st.deferred_peak = len(st.deferred)
        return []

    def _shed(self, t: int, job: Job) -> None:
        """Drop an arrival outright: it never enters the cluster books
        (so ``_has_pending_work`` can still reach quiescence) and is
        recorded on :attr:`SimResult.shed_jobs` with its would-be
        arrival slot."""
        cluster = self.engine.cluster
        cluster.jobs.pop(job.job_id, None)
        cluster.remaining.pop(job.job_id, None)
        st = self._res
        st.shed[job.job_id] = job.arrival
        st.metrics.inc("jobs.shed")
        if self.obs is not None:
            self.obs.job_shed(t, job.job_id)

    def _admit_deferred(self, t: int) -> None:
        """Drain the pending queue FIFO while the lag stays inside the
        defer budget; called at the top of every service tick."""
        cluster = self.engine.cluster
        st = self._res
        cfg = self.resilience
        while st.deferred:
            lag = int(cluster.busy_times().max())
            if lag > cfg.lag_defer_budget:
                break
            job = st.deferred.popleft()
            self.overheads.extend(self.engine._admit_burst([job]))

    # ---- retry-with-backoff on data loss ---------------------------------

    def _park_for_retry(self, job_id: int, per_group: dict[int, int]) -> bool:
        """Engine data-loss hook: a stranded fragment with no live
        replica left is parked and a placement retry scheduled after an
        exponential backoff, instead of failing the job.  Returns False
        once attempts are exhausted (the engine then fails it)."""
        st = self._res
        cfg = self.resilience
        attempts = st.retry_attempts.get(job_id, 0)
        if attempts >= cfg.retry_limit:
            return False
        parked = st.parked.setdefault(job_id, {})
        for g, cnt in per_group.items():
            parked[g] = parked.get(g, 0) + cnt
        if job_id not in st.retry_due:
            delay = min(
                cfg.retry_backoff_base << attempts, cfg.retry_backoff_max
            )
            st.retry_due.add(job_id)
            self._push(self._now + delay, _P_EVENT, _Retry(job_id))
            st.metrics.inc("retry.parked")
        return True

    def _retry_fire(self, t: int, job_id: int) -> None:
        """Timeline side of the retry: re-attempt placement of the
        parked fragment; re-park (or fail, once exhausted) when there is
        still no live replica — e.g. the rack has not recovered yet."""
        cluster = self.engine.cluster
        st = self._res
        st.retry_due.discard(job_id)
        per_group = st.parked.pop(job_id, None)
        if (
            per_group is None
            or job_id in cluster.failed
            or job_id not in cluster.remaining
        ):
            return
        st.retry_attempts[job_id] = st.retry_attempts.get(job_id, 0) + 1
        st.metrics.inc("retry.attempted")
        self.retries += 1
        if self.obs is not None:
            self.obs.job_retry(t, job_id)
        job = cluster.jobs[job_id]
        proj = cluster.project(job, per_group)
        if proj is None:
            if not self._park_for_retry(job_id, per_group):
                cluster.mark_failed(job_id)
                st.metrics.inc("retry.exhausted")
            return
        groups, gids = proj
        prob = cluster.problem_for(job, groups)
        assignment = self.engine.policy.assign(prob)
        if self.engine.debug:
            assignment.validate(prob)
        cluster.enqueue(job_id, assignment, gids)
        cluster.reassigned += sum(per_group.values())
        if self.obs is not None:
            self.obs.reassign(t, job_id, sum(per_group.values()))
        self._ensure_service(t)
