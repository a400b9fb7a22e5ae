"""The scheduling engine: drives job traces through a cluster under a policy.

The port's copy of ``repro/runtime/engine.py``, observability hooks
included (:mod:`repro_torch.obs`: an ambient session records the run and
changes nothing in it).  Implements the
paper's execution model exactly (Sec. II): time is divided
into identical slots, servers hold FIFO queues of outstanding job tasks,
and server ``m`` processes up to ``μ_m^h`` tasks of its *head* job per
slot, so the backlog cost is ``⌈o_m^h/μ_m^h⌉`` per queued job — matching
the busy-time estimate of eq. 2 by construction.

Arrivals sharing a slot are admitted as one *burst*: FIFO policies place
the whole burst through :meth:`SchedulingPolicy.assign_batch` (for
``wf_torch`` and ``rd_torch`` that is one chained device pass; everything
else walks the burst with eq. 2 commits), with results identical to
per-arrival admission by
construction.  Reordering policies (OCWF, OCWF-ACC, SETF) re-order and
re-assign the whole outstanding set — per arrival as in the paper, except
that a same-slot burst is folded into one rescan (task totals are
conserved within the slot, so the final reschedule subsumes the
intermediate ones; schedules are identical either way).
Beyond the paper, the engine supports fault-tolerance events (server
failure / slowdown) with locality-aware reassignment of affected tasks;
a failed server's stranded fragments are merged per job before
reassignment so the policy re-places each job's tasks jointly.

With a :class:`repro_torch.placement.PlacementStore`, eligible sets
become *runtime state*: placement-backed jobs
(:class:`repro_torch.placement.PlacedJob`) re-resolve their groups from
the live store at arrival, and
:class:`repro_torch.placement.PlacementEvent`\\ s ride the same timeline
as fault events — a deleted replica strands the queued fragments that read
its block exactly like a server failure (re-placed per job through the
policy), a replica add widens the locality sets of queued and future
jobs, and a rebalance runs the store's replication policy with evictions
routed through the stranding path.  With a static store and no placement
events the realized schedule is bit-identical to frozen-tuple traces.

``step_mode="event"`` hands the run to the event-stepped
:class:`repro_torch.runtime.loop.ControlPlane` (imported lazily: the
loop imports this module).  State lives in
:class:`repro_torch.runtime.cluster.ClusterState`; events in
:class:`repro_torch.runtime.events.EventTimeline`; policies in
:mod:`repro_torch.runtime.policies`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from ..core import AssignmentProblem, Job, OutstandingJob, TaskGroup
from ..obs import clock
from ..obs.session import ObsSession, active as obs_active
from ..placement import PlacedJob, PlacementEvent, PlacementStore

from .cluster import ClusterState
from .events import EventTimeline, RackEvent, ServerEvent
from .policies import Policy, SchedulingPolicy, make_policy
from .resilience import ResilienceConfig

__all__ = ["SchedulingEngine", "SimResult"]


@dataclasses.dataclass
class SimResult:
    """Outcome of one run.  Jobs partition into completed (``jct``),
    failed (``failed_jobs``: data loss), and shed (``shed_jobs``:
    rejected by admission control before any work ran).  Every JCT
    statistic (``mean_jct``, percentiles, ``jct_cdf``) is over completed
    jobs only — shed jobs are counted separately, never averaged in."""

    jct: dict[int, int]  # job_id -> completion time (slots)
    overhead_s: list[float]  # per-arrival scheduling wall time
    makespan: int
    failed_jobs: list[int]  # jobs whose data became unavailable
    reassignments: int = 0  # tasks moved by fault handling
    steals: int = 0  # tasks moved by work-stealing (event mode)
    speculations: int = 0  # straggler fragments cloned (event mode)
    spec_cancels: int = 0  # speculative losers canceled (event mode)
    serve_latency: dict[int, int] = dataclasses.field(default_factory=dict)
    # serve requests still in flight when the plane drained (their
    # latencies are NOT in serve_latency — they never finished)
    inflight_requests: int = 0
    # jobs rejected by admission control: job_id -> would-be arrival slot
    shed_jobs: dict[int, int] = dataclasses.field(default_factory=dict)
    deferred_peak: int = 0  # high-water mark of the admission queue
    retries: int = 0  # data-loss retry attempts fired (event mode)
    heap_peak: int = 0  # high-water mark of the event heap (event mode)

    @property
    def n_shed(self) -> int:
        return len(self.shed_jobs)

    @property
    def mean_jct(self) -> float:
        # NaN, not 0.0: an empty result must not read as "instant JCT" —
        # including windows where every arriving job was shed
        return float(np.mean(list(self.jct.values()))) if self.jct else float("nan")

    @property
    def mean_overhead_s(self) -> float:
        return float(np.mean(self.overhead_s)) if self.overhead_s else 0.0

    def jct_percentile(self, q: float) -> float:
        if not self.jct:
            return float("nan")
        return float(np.percentile(list(self.jct.values()), q))

    def jct_cdf(self) -> tuple[np.ndarray, np.ndarray]:
        if not self.jct:
            empty = np.asarray([], dtype=np.int64)
            return empty, empty.astype(np.float64)
        v = np.sort(np.asarray(list(self.jct.values())))
        return v, np.arange(1, v.size + 1) / v.size


class SchedulingEngine:
    """Drives a trace of :class:`repro_torch.core.Job` under a pluggable policy.

    ``debug=True`` validates every assignment on every enqueue path (admit,
    burst, reorder, fault reassignment) and cross-checks the incremental
    busy-time vector against the eq. 2 rescan — kept off by default to
    keep the hot loop hot.  ``batch_arrivals=False`` forces per-arrival
    admission (the pre-batching behavior; used by equivalence tests).
    """

    def __init__(
        self,
        n_servers: int,
        policy: SchedulingPolicy | Policy | str = "wf",
        *,
        events: tuple[ServerEvent | RackEvent | PlacementEvent, ...] = (),
        placement: PlacementStore | None = None,
        max_slots: int = 10_000_000,
        on_slot: Callable[[ClusterState, int], None] | None = None,
        debug: bool = False,
        batch_arrivals: bool = True,
        step_mode: str = "slot",
        stealing: bool = False,
        speculation: bool = False,
        spec_factor: float | None = None,
        resilience: ResilienceConfig | None = None,
        obs: ObsSession | None = None,
    ):
        if step_mode not in ("slot", "event"):
            raise ValueError(
                f"unknown step_mode {step_mode!r}; expected 'slot' or 'event'"
            )
        if step_mode == "slot" and (stealing or speculation):
            raise ValueError(
                "work-stealing/speculation are online mechanisms; they "
                "require step_mode='event'"
            )
        if step_mode == "slot" and (
            resilience is not None and (resilience.admission or resilience.retry)
        ):
            raise ValueError(
                "admission control / retry are online mechanisms; they "
                "require step_mode='event'"
            )
        self.step_mode = step_mode
        self.stealing = stealing
        self.speculation = speculation
        self.spec_factor = spec_factor
        self.resilience = resilience
        # data-loss interception (retry-with-backoff): set by the control
        # plane; returns True when the stranded fragment was parked for a
        # later retry instead of failing the job
        self.on_data_loss: Callable[[int, dict[int, int]], bool] | None = None
        self.n_servers = n_servers
        self.policy = make_policy(policy) if isinstance(policy, str) else policy
        self.events = tuple(sorted(events, key=lambda e: e.slot))
        self.placement = placement
        if placement is not None and placement.n_servers != n_servers:
            raise ValueError(
                f"placement store spans {placement.n_servers} servers, "
                f"engine drives {n_servers}"
            )
        if placement is None and any(
            isinstance(e, PlacementEvent) for e in self.events
        ):
            raise ValueError("placement events require a placement store")
        self.max_slots = max_slots
        self.on_slot = on_slot  # observability/test hook, called once per slot
        self.debug = debug
        self.batch_arrivals = batch_arrivals
        self.obs = obs if obs is not None else obs_active()
        self.cluster: ClusterState | None = None  # populated by run()
        # block -> [(job_id, original gid)] for arrived placement-backed jobs
        self._block_groups: dict[str, list[tuple[int, int]]] = {}

    # ---- reordering ------------------------------------------------------

    def _attained(self) -> dict[int, int]:
        """Tasks already processed per live job (SETF's elapsed service)."""
        assert self.cluster is not None
        return {
            job_id: self.cluster.jobs[job_id].n_tasks - rem
            for job_id, rem in self.cluster.remaining.items()
        }

    def _reschedule(
        self,
        extras: list[tuple[OutstandingJob, list[int]]] = (),
    ) -> None:
        """Re-order and re-assign all outstanding jobs plus ``extras``
        (not-yet-enqueued arrivals paired with their original gids)."""
        cluster = self.cluster
        outstanding, gid_maps = cluster.outstanding()
        for extra, extra_gids in extras:
            outstanding.append(extra)
            gid_maps[extra.job_id] = list(extra_gids)
        schedule, _ = self.policy.schedule(
            outstanding, self.n_servers, attained=self._attained()
        )
        cluster.clear_queues()
        if self.debug:
            # locality + task-conservation check only (validate never reads
            # busy times; the placeholder vector just satisfies the schema)
            zeros = np.zeros(self.n_servers, dtype=np.int64)
            by_id = {j.job_id: j for j in outstanding}
            for job_id, assignment in schedule:
                j = by_id[job_id]
                assignment.validate(
                    AssignmentProblem(busy=zeros, mu=j.mu, groups=j.groups)
                )
        for job_id, assignment in schedule:
            cluster.enqueue(job_id, assignment, gid_maps[job_id])

    # ---- fault handling --------------------------------------------------

    def _merge_stranded(
        self,
        stranded: list,
        merged: dict[int, dict[int, int]] | None = None,
    ) -> dict[int, dict[int, int]]:
        """Merge stranded segments into per-job reassignment problems so
        the policy can balance each job's displaced tasks jointly."""
        cluster = self.cluster
        if merged is None:
            merged = {}
        for seg in stranded:
            if seg.job_id in cluster.failed:
                continue
            acc = merged.setdefault(seg.job_id, {})
            for g, cnt in seg.per_group.items():
                acc[g] = acc.get(g, 0) + cnt
        return merged

    def _reassign_stranded(self, merged: dict[int, dict[int, int]]) -> None:
        """Re-place merged stranded fragments through the policy.  A job
        whose every live replica is gone is parked for retry when the
        control plane installed :attr:`on_data_loss` (and it accepts),
        otherwise marked failed — the pre-resilience behavior."""
        cluster = self.cluster
        for job_id, per_group in merged.items():
            if job_id in cluster.failed:
                continue
            job = cluster.jobs[job_id]
            proj = cluster.project(job, per_group)
            if proj is None:
                hook = self.on_data_loss
                if hook is not None and hook(job_id, per_group):
                    continue
                cluster.mark_failed(job_id)
                continue
            groups, gids = proj
            prob = cluster.problem_for(job, groups)
            assignment = self.policy.assign(prob)
            if self.debug:
                assignment.validate(prob)
            cluster.enqueue(job_id, assignment, gids)
            cluster.reassigned += sum(per_group.values())
            if self.obs is not None:
                self.obs.reassign(
                    self.obs.sim_now, job_id, sum(per_group.values())
                )

    def _apply_rack_event(self, ev: RackEvent) -> None:
        """Correlated fault: fail (or recover) every server in the rack
        in one slot, merging each job's stranded fragments across the
        whole rack before re-placement."""
        cluster = self.cluster
        if ev.kind == "fail":
            merged: dict[int, dict[int, int]] = {}
            for m in ev.servers:
                if cluster.alive[m]:
                    self._merge_stranded(cluster.fail_server(m), merged)
            self._reassign_stranded(merged)
        else:  # "recover"
            for m in ev.servers:
                if not cluster.alive[m]:
                    cluster.recover_server(m)

    def _apply_event(self, ev: ServerEvent | RackEvent) -> None:
        if isinstance(ev, RackEvent):
            self._apply_rack_event(ev)
            return
        cluster = self.cluster
        m = ev.server
        if ev.kind == "fail":
            self._reassign_stranded(
                self._merge_stranded(cluster.fail_server(m))
            )
        elif ev.kind == "recover":
            cluster.recover_server(m)
        elif ev.kind == "slowdown":
            cluster.slow[m] = ev.factor
            cluster.invalidate_mu()
            if self.policy.reorders:  # straggler mitigation: rebalance all
                self._reschedule()
        elif ev.kind == "speedup":
            cluster.slow[m] = 1.0
            cluster.invalidate_mu()

    # ---- placement changes -----------------------------------------------

    def _live_block_groups(self, block: str) -> list[tuple[int, int]]:
        """(job_id, gid) pairs of arrived, still-live jobs reading ``block``."""
        cluster = self.cluster
        return [
            (job_id, g)
            for job_id, g in self._block_groups.get(block, ())
            if job_id in cluster.remaining
        ]

    def _set_group_servers(
        self, job_id: int, g: int, servers: tuple[int, ...]
    ) -> None:
        cluster = self.cluster
        job = cluster.jobs[job_id]
        groups = list(job.groups)
        groups[g] = TaskGroup(job.groups[g].size, servers)
        cluster.jobs[job_id] = dataclasses.replace(job, groups=tuple(groups))

    def _widen_block(self, block: str, server: int) -> bool:
        """A new replica of ``block`` on ``server``: live jobs reading it
        may now also run there (future jobs re-resolve at arrival).
        Returns True when a live job's locality set actually widened."""
        widened = False
        for job_id, g in self._live_block_groups(block):
            servers = self.cluster.jobs[job_id].groups[g].servers
            if server not in servers:
                self._set_group_servers(
                    job_id, g, tuple(sorted(servers + (server,)))
                )
                widened = True
        return widened

    def _evict_replica(self, block: str, server: int) -> None:
        """Delete ``block``'s replica on ``server``: strand the queued
        fragments that read it (exactly like a server fault strands a
        queue) and re-place them per job; narrow live locality sets; a
        group losing its last replica fails its job."""
        if not self.placement.evict(block, server):
            return  # replica already gone (stale churn event) — no-op
        cluster = self.cluster
        affected = self._live_block_groups(block)
        stranded: dict[int, dict[int, int]] = {}
        for job_id, g in affected:
            cnt = cluster.evict_queued(server, job_id, g)
            if cnt:
                stranded.setdefault(job_id, {})[g] = cnt
        for job_id, g in affected:
            if job_id in cluster.failed:
                continue
            remaining = tuple(
                s for s in cluster.jobs[job_id].groups[g].servers if s != server
            )
            if remaining:
                self._set_group_servers(job_id, g, remaining)
            elif stranded.get(job_id, {}).get(g):
                # last replica gone with unprocessed tasks: data loss
                cluster.mark_failed(job_id)
            # else: the group is fully processed — nothing to narrow
        for job_id, per_group in stranded.items():
            if job_id in cluster.failed:
                continue
            job = cluster.jobs[job_id]
            proj = cluster.project(job, per_group)
            if proj is None:
                cluster.mark_failed(job_id)
                continue
            groups, gids = proj
            prob = cluster.problem_for(job, groups)
            assignment = self.policy.assign(prob)
            if self.debug:
                assignment.validate(prob)
            cluster.enqueue(job_id, assignment, gids)
            cluster.reassigned += sum(per_group.values())
            if self.obs is not None:
                self.obs.reassign(
                    self.obs.sim_now, job_id, sum(per_group.values())
                )

    def _apply_placement_event(self, ev: PlacementEvent) -> None:
        store = self.placement
        widened = False
        if ev.kind == "add":
            if ev.block in store and store.add_replica(ev.block, ev.server):
                widened = self._widen_block(ev.block, ev.server)
        elif ev.kind == "evict":
            if ev.block in store:
                self._evict_replica(ev.block, ev.server)
        elif ev.kind == "join":
            store.server_join(ev.server)
        elif ev.kind == "leave":
            for block in store.blocks_on(ev.server):
                self._evict_replica(block, ev.server)
            store.server_leave(ev.server)
        elif ev.kind == "rebalance":
            delta = store.propose(np.random.default_rng(ev.seed))
            for block, server in delta.added:
                if block in store and store.add_replica(block, server):
                    widened |= self._widen_block(block, server)
            for block, server in delta.evicted:
                if block in store:
                    self._evict_replica(block, server)
        if widened and self.policy.reorders:
            # a wider locality set is only realized by re-placing queued
            # work — same rebalance trigger as the slowdown handler
            self._reschedule()

    # ---- arrivals --------------------------------------------------------

    def _resolve_placed(self, job: Job) -> Job | None:
        """Re-resolve a placement-backed job's groups from the live store
        at arrival; returns None (job marked failed) if any block's data
        is gone.  Plain jobs (or no store) pass through untouched."""
        store = self.placement
        if store is None or not isinstance(job, PlacedJob):
            return job
        resolved = job.resolve(store)
        if resolved is None:
            self.cluster.mark_failed(job.job_id)
            return None
        self.cluster.jobs[job.job_id] = resolved
        for g, (grp, block) in enumerate(zip(resolved.groups, resolved.blocks)):
            self._block_groups.setdefault(block, []).append((job.job_id, g))
            store.record_access(block, grp.size)
        return resolved

    def _admit_one(self, job: Job) -> float | None:
        """Place one arriving job; returns scheduling wall time (None if
        the job's data is already unavailable)."""
        cluster = self.cluster
        job = self._resolve_placed(job)
        if job is None:
            return None
        proj = cluster.project(
            job, {g: grp.size for g, grp in enumerate(job.groups)}
        )
        if proj is None:
            cluster.mark_failed(job.job_id)
            return None
        groups, gids = proj
        t0 = clock.perf_counter()
        if self.policy.reorders:
            self._reschedule(
                [(
                    OutstandingJob(
                        job_id=job.job_id,
                        groups=groups,
                        mu=cluster.effective_mu(job),
                    ),
                    gids,
                )]
            )
        else:
            prob = cluster.problem_for(job, groups)
            assignment = self.policy.assign(prob)
            if self.debug:
                assignment.validate(prob)
            cluster.enqueue(job.job_id, assignment, gids)
        elapsed = clock.perf_counter() - t0
        if self.obs is not None:
            self.obs.job_admitted(self.obs.sim_now, job.job_id, elapsed)
        return elapsed

    def _project_batch(self, batch: list[Job]) -> list[tuple[Job, tuple, list[int]]]:
        """Project each burst job onto alive servers; jobs whose data is
        gone are marked failed and dropped.  Returns (job, groups, gids)."""
        cluster = self.cluster
        admitted: list[tuple[Job, tuple, list[int]]] = []
        for job in batch:
            job = self._resolve_placed(job)
            if job is None:
                continue
            proj = cluster.project(
                job, {g: grp.size for g, grp in enumerate(job.groups)}
            )
            if proj is None:
                cluster.mark_failed(job.job_id)
                continue
            admitted.append((job, proj[0], proj[1]))
        return admitted

    def _admit_burst(self, batch: list[Job]) -> list[float]:
        """Admit all arrivals sharing a slot; returns per-job wall times.

        FIFO policies place the burst via :meth:`Policy.assign_batch` in
        one call (for ``wf_torch`` / ``rd_torch``, one chained device
        pass); the results
        are identical to per-arrival admission because the batch path
        commits eq. 2 between jobs exactly as :meth:`ClusterState.enqueue`
        would.  Reordering policies (OCWF, OCWF-ACC, SETF) fold the burst
        into ONE rescan: per-arrival rescans within a slot only reshuffle
        queues that the next rescan rebuilds from scratch, and task totals
        are conserved in between, so the final reschedule subsumes the
        intermediate ones — schedules are identical by construction (and
        equivalence-tested on the bursty scenario).  A burst of one takes
        the per-arrival path.

        Each burst job's recorded overhead is the burst's *amortized*
        wall time (total / burst size): the sum and mean stay comparable
        with sequential admission, but percentiles describe amortized
        cost, not the stall of the job that happened to trigger the
        dispatch.
        """
        cluster = self.cluster
        batch_fn = getattr(self.policy, "assign_batch", None)
        if not self.batch_arrivals or len(batch) == 1:
            return [o for j in batch if (o := self._admit_one(j)) is not None]
        if self.policy.reorders:
            return self._admit_burst_reorder(batch)
        if batch_fn is None:
            return [o for j in batch if (o := self._admit_one(j)) is not None]
        t0 = clock.perf_counter()
        admitted = self._project_batch(batch)
        if not admitted:
            return []
        base_busy = cluster.busy_times()
        problems = [
            AssignmentProblem(
                busy=base_busy, mu=cluster.effective_mu(job), groups=groups
            )
            for job, groups, _ in admitted
        ]
        assignments = batch_fn(problems)
        for (job, _, gids), prob, assignment in zip(
            admitted, problems, assignments
        ):
            if self.debug:
                assignment.validate(prob)
            cluster.enqueue(job.job_id, assignment, gids)
        elapsed = clock.perf_counter() - t0
        if self.obs is not None:
            for job, _, _ in admitted:
                self.obs.job_admitted(
                    self.obs.sim_now, job.job_id, elapsed / len(admitted)
                )
        return [elapsed / len(admitted)] * len(admitted)

    def _admit_burst_reorder(self, batch: list[Job]) -> list[float]:
        """Fold a same-slot burst into a single reordering rescan.

        Sequential admission would run one full :meth:`_reschedule` per
        arrival, but every intermediate rescan's queues are torn down by
        the next one while ``remaining``/``attained`` stay fixed within
        the slot — only the last rescan (with the whole burst outstanding)
        determines the realized schedule, so running just that one is
        schedule-identical at 1/len(batch) of the rescan cost.
        """
        cluster = self.cluster
        t0 = clock.perf_counter()
        extras = [
            (
                OutstandingJob(
                    job_id=job.job_id,
                    groups=groups,
                    mu=cluster.effective_mu(job),
                ),
                gids,
            )
            for job, groups, gids in self._project_batch(batch)
        ]
        if not extras:
            return []
        self._reschedule(extras)
        elapsed = clock.perf_counter() - t0
        if self.obs is not None:
            for extra, _ in extras:
                self.obs.job_admitted(
                    self.obs.sim_now, extra.job_id, elapsed / len(extras)
                )
        return [elapsed / len(extras)] * len(extras)

    # ---- main loop -------------------------------------------------------

    def run(self, jobs: list[Job]) -> SimResult:
        if self.step_mode == "event":
            from .loop import ControlPlane  # lazy: loop imports this module

            plane = ControlPlane(
                self.n_servers,
                policy=self.policy,
                events=self.events,
                placement=self.placement,
                stealing=self.stealing,
                speculation=self.speculation,
                spec_factor=self.spec_factor,
                resilience=self.resilience,
                max_slots=self.max_slots,
                on_slot=self.on_slot,
                debug=self.debug,
                batch_arrivals=self.batch_arrivals,
                obs=self.obs,
            )
            plane.submit_many(jobs)
            result = plane.drain()
            self.cluster = plane.engine.cluster  # expose final state as usual
            return result
        return self._run_slot(jobs)

    def _run_slot(self, jobs: list[Job]) -> SimResult:
        self.cluster = cluster = ClusterState(
            self.n_servers,
            {j.job_id: j for j in jobs},
            debug=self.debug,
            obs=self.obs,
        )
        self._block_groups = {}
        timeline = EventTimeline(self.events)
        arrivals = sorted(jobs, key=lambda j: (j.arrival, j.job_id))
        jct: dict[int, int] = {}
        overheads: list[float] = []
        obs = self.obs
        ai = slot = 0
        while slot < self.max_slots:
            if obs is not None:
                obs.sim_now = slot
            for ev in timeline.due(slot):
                if isinstance(ev, PlacementEvent):
                    self._apply_placement_event(ev)
                else:
                    self._apply_event(ev)
            batch: list[Job] = []
            while ai < len(arrivals) and arrivals[ai].arrival <= slot:
                job = arrivals[ai]
                ai += 1
                if obs is not None:
                    obs.job_arrival(slot, job.job_id, job.n_tasks)
                if job.n_tasks == 0:
                    jct[job.job_id] = 0  # empty job completes at arrival
                    if obs is not None:
                        obs.job_complete(slot, job.job_id, job.arrival, 0, 0)
                    continue
                batch.append(job)
            if batch:
                overheads.extend(self._admit_burst(batch))
            for job_id, n_done in cluster.process_slot().items():
                if job_id not in cluster.remaining:
                    continue
                if obs is not None:
                    obs.service_progress(slot, job_id, n_done)
                cluster.remaining[job_id] -= n_done
                if cluster.remaining[job_id] <= 0:
                    job = cluster.jobs[job_id]
                    jct[job_id] = slot + 1 - job.arrival
                    del cluster.remaining[job_id]
                    if obs is not None:
                        obs.job_complete(
                            slot, job_id, job.arrival, jct[job_id], job.n_tasks
                        )
            if self.on_slot is not None:
                self.on_slot(cluster, slot)
            if obs is not None:
                obs.snapshot(slot, cluster)
            slot += 1
            if ai >= len(arrivals) and not cluster.remaining:
                break
        else:
            raise RuntimeError("simulation exceeded max_slots — livelock?")
        return SimResult(
            jct=jct,
            overhead_s=overheads,
            makespan=slot,
            failed_jobs=cluster.failed,
            reassignments=cluster.reassigned,
        )
