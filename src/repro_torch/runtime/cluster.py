"""Cluster state: server queues, liveness, and the busy-time model (eq. 2).

The port's copy of ``repro/runtime/cluster.py``, observability hooks
included.  The bookkeeping invariant that everything here protects: queue segments
are always keyed by the job's *original* group index, so locality sets
(``job.groups[g].servers``) stay correct across arbitrarily many reorders
and fault-driven reassignments.  :meth:`ClusterState.assert_invariant`
makes the invariant executable for tests.

Busy times are maintained *incrementally*: ``enqueue`` adds each new
segment's ``⌈o/μ⌉`` cost, ``process_slot`` subtracts the ceiling delta as
the head segment drains, and queue-structure mutations (``clear_queues``,
``mark_failed``, ``fail_server``) adjust or zero the affected servers.
Capacity changes (slowdown/speedup via :meth:`invalidate_mu`) mark the
vector stale and the next :meth:`busy_times` call recomputes it from the
queues.  With ``debug=True`` every :meth:`busy_times` call cross-checks
the incremental vector against the O(queued segments) rescan.

reprolint's R005 exempts the reference's ``repro.runtime.cluster`` by
name, so each write of the eq. 2 state here carries an inline pragma.
"""

from __future__ import annotations

from collections import deque

import numpy as np

from ..core import Assignment, AssignmentProblem, Job, OutstandingJob, TaskGroup

__all__ = ["QueueSegment", "ClusterState"]


class QueueSegment:
    """Contiguous run of one job's tasks on one server's queue.

    ``per_group`` maps *original* group index -> task count.
    """

    __slots__ = ("job_id", "per_group", "total")

    def __init__(self, job_id: int, per_group: dict[int, int]):
        self.job_id = job_id
        self.per_group = {g: c for g, c in per_group.items() if c > 0}
        self.total = sum(self.per_group.values())

    def take(self, n: int) -> int:
        """Remove up to n tasks; returns how many were taken."""
        taken = 0
        for g in list(self.per_group):
            if taken >= n:
                break
            d = min(self.per_group[g], n - taken)
            self.per_group[g] -= d
            taken += d
            if self.per_group[g] == 0:
                del self.per_group[g]
        self.total -= taken
        return taken


class ClusterState:
    """Mutable server-side state the scheduling engine drives.

    Time semantics follow the paper's slotted model (Sec. II): server ``m``
    processes up to ``μ_m^h`` head-of-queue tasks per slot, and a partially
    filled slot is still a full slot, so each queued job costs
    ``⌈o_m^h/μ_m^h⌉`` slots — eq. 2 holds *by construction*.
    """

    def __init__(
        self,
        n_servers: int,
        jobs: dict[int, Job],
        *,
        debug: bool = False,
        obs=None,
    ):
        self.n_servers = n_servers
        self.jobs = jobs
        self.debug = debug
        self.obs = obs  # ObsSession | None; observation-only hooks
        self.queues: list[deque[QueueSegment]] = [deque() for _ in range(n_servers)]
        self.alive = np.ones(n_servers, dtype=bool)
        self.slow = np.ones(n_servers, dtype=np.float64)
        self.remaining = {j.job_id: j.n_tasks for j in jobs.values() if j.n_tasks > 0}
        self.failed: list[int] = []
        self.reassigned = 0
        self._mu_cache: dict[int, np.ndarray] = {}
        self._busy = np.zeros(n_servers, dtype=np.int64)  # reprolint: disable=R005 the port's ClusterState owns its eq. 2 vector
        self._busy_stale = False  # reprolint: disable=R005 the port's ClusterState owns its eq. 2 vector
        # per-tick service observation (read-only for consumers): tasks
        # the last process_slot took per server, and the head job they
        # were taken from — valid only where last_progress > 0, which
        # sidesteps any idle-sentinel collision with negative shadow ids
        self.last_progress = np.zeros(n_servers, dtype=np.int64)
        self.last_head_job = np.zeros(n_servers, dtype=np.int64)

    # ---- capacity & busy time -------------------------------------------

    def effective_mu(self, job: Job) -> np.ndarray:
        cached = self._mu_cache.get(job.job_id)
        if cached is None:
            cached = np.maximum(1, (job.mu / self.slow).astype(np.int64))
            self._mu_cache[job.job_id] = cached
        return cached

    def invalidate_mu(self) -> None:
        """Per-job capacities changed (slowdown/speedup): every queued
        segment's ceiling cost changes with them, so the incremental busy
        vector is stale until the next :meth:`busy_times` rescan."""
        self._mu_cache.clear()
        self._busy_stale = True  # reprolint: disable=R005 the port's ClusterState owns its eq. 2 vector

    def _segment_cost(self, seg: QueueSegment, m: int) -> int:
        mu = int(self.effective_mu(self.jobs[seg.job_id])[m])
        return -(-seg.total // mu)

    def _rescan_busy(self) -> np.ndarray:
        """eq. 2 from scratch: b_m = Σ_h ⌈o_m^h / μ_m^h⌉ over queued
        segments (the reference the incremental vector is checked against)."""
        busy = np.zeros(self.n_servers, dtype=np.int64)
        for m in range(self.n_servers):
            if not self.alive[m]:
                continue
            for seg in self.queues[m]:
                busy[m] += self._segment_cost(seg, m)
        return busy

    def busy_times(self) -> np.ndarray:
        """eq. 2 busy-time vector, maintained incrementally (O(M) here)."""
        if self._busy_stale:
            self._busy = self._rescan_busy()  # reprolint: disable=R005 the port's ClusterState owns its eq. 2 vector
            self._busy_stale = False  # reprolint: disable=R005 the port's ClusterState owns its eq. 2 vector
        if self.debug:
            rescan = self._rescan_busy()
            if not np.array_equal(self._busy, rescan):
                raise AssertionError(
                    f"incremental busy times diverged from rescan: "
                    f"{self._busy.tolist()} != {rescan.tolist()}"
                )
        return self._busy.copy()

    def live_servers(self, group: TaskGroup) -> tuple[int, ...]:
        return tuple(m for m in group.servers if self.alive[m])

    # ---- liveness --------------------------------------------------------

    def fail_server(self, m: int) -> list[QueueSegment]:
        """Mark ``m`` dead and drain its queue; returns stranded segments."""
        self.alive[m] = False
        stranded = list(self.queues[m])
        self.queues[m].clear()
        self._busy[m] = 0  # dead servers contribute no busy time  # reprolint: disable=R005 the port's ClusterState owns its eq. 2 vector
        return stranded

    def recover_server(self, m: int) -> None:
        self.alive[m] = True
        # queue was drained at failure, so the busy contribution is zero
        assert not self.queues[m], "recovered server has a non-empty queue"

    # ---- replica eviction (placement layer) ------------------------------

    def evict_queued(self, m: int, job_id: int, g: int) -> int:
        """Strand queued group-``g`` tasks of ``job_id`` on server ``m``.

        The placement analogue of :meth:`fail_server`: when server ``m``
        loses its replica of the block group ``g`` reads, the tasks
        queued there can no longer run locally and must be re-placed.
        Removes the matching per-group entries (other groups sharing a
        segment stay queued), keeps the incremental busy vector in step,
        and returns the stranded task count.
        """
        taken = 0
        q = self.queues[m]
        track = not self._busy_stale and self.alive[m]
        for seg in list(q):
            if seg.job_id != job_id or g not in seg.per_group:
                continue
            cost_before = self._segment_cost(seg, m) if track else 0
            cnt = seg.per_group.pop(g)
            seg.total -= cnt
            taken += cnt
            if track:
                self._busy[m] -= cost_before - self._segment_cost(seg, m)  # reprolint: disable=R005 the port's ClusterState owns its eq. 2 vector
            if seg.total == 0:
                q.remove(seg)
        return taken

    # ---- segment surgery (work-stealing / speculation) -------------------

    def pull_from_segment(
        self, m: int, seg: QueueSegment, gids: list[int]
    ) -> dict[int, int]:
        """Remove the given original-group entries from ``seg`` (queued on
        server ``m``), keeping the incremental busy vector in step.

        Returns ``{gid: count}`` actually pulled; an emptied segment is
        dropped from the queue.  This is the work-stealing primitive: the
        puller re-places the pulled fragment through the policy exactly
        like the fail path re-places stranded segments.
        """
        track = not self._busy_stale and self.alive[m]
        cost_before = self._segment_cost(seg, m) if track else 0
        pulled: dict[int, int] = {}
        for g in gids:
            cnt = seg.per_group.pop(g, 0)
            if cnt:
                pulled[g] = cnt
        seg.total -= sum(pulled.values())
        if track:
            self._busy[m] -= cost_before - self._segment_cost(seg, m)  # reprolint: disable=R005 the port's ClusterState owns its eq. 2 vector
        if seg.total == 0:
            self.queues[m].remove(seg)
        return pulled

    def adopt_segment(self, m: int, seg: QueueSegment) -> None:
        """Append an existing segment object to ``m``'s queue (speculative
        clone placement), keeping the incremental busy vector in step.
        ``seg.job_id`` must already be registered in :attr:`jobs`."""
        self.queues[m].append(seg)
        if not self._busy_stale and self.alive[m]:
            self._busy[m] += self._segment_cost(seg, m)  # reprolint: disable=R005 the port's ClusterState owns its eq. 2 vector

    def remove_segment(self, m: int, seg: QueueSegment) -> None:
        """Remove a queued segment (speculative-loser cancellation),
        delta-correcting the eq. 2 busy vector by the segment's remaining
        ceiling cost."""
        self.queues[m].remove(seg)
        if not self._busy_stale and self.alive[m]:
            self._busy[m] -= self._segment_cost(seg, m)  # reprolint: disable=R005 the port's ClusterState owns its eq. 2 vector

    # ---- job bookkeeping -------------------------------------------------

    def mark_failed(self, job_id: int) -> None:
        if job_id not in self.failed:
            self.failed.append(job_id)
            if self.obs is not None:
                self.obs.job_failed(self.obs.sim_now, job_id)
        self.remaining.pop(job_id, None)
        # purge zombie segments so queues don't process unaccounted tasks
        for m, q in enumerate(self.queues):
            for seg in list(q):
                if seg.job_id == job_id:
                    q.remove(seg)
                    if not self._busy_stale and self.alive[m]:
                        self._busy[m] -= self._segment_cost(seg, m)  # reprolint: disable=R005 the port's ClusterState owns its eq. 2 vector

    def enqueue(self, job_id: int, assignment: Assignment, gids: list[int]) -> None:
        """Append assignment to queues; alloc index i corresponds to
        original group id gids[i]."""
        per_server: dict[int, dict[int, int]] = {}
        for i, per in enumerate(assignment.alloc):
            g = gids[i]
            for m, cnt in per.items():
                if cnt <= 0:
                    continue
                bucket = per_server.setdefault(m, {})
                bucket[g] = bucket.get(g, 0) + cnt
        obs = self.obs
        job = self.jobs.get(job_id) if obs is not None else None
        for m, per_group in per_server.items():
            seg = QueueSegment(job_id, per_group)
            self.queues[m].append(seg)
            if not self._busy_stale and self.alive[m]:
                self._busy[m] += self._segment_cost(seg, m)  # reprolint: disable=R005 the port's ClusterState owns its eq. 2 vector
            if job is not None:
                obs.enqueued(job, m, seg.per_group)

    def clear_queues(self) -> None:
        self.queues = [deque() for _ in range(self.n_servers)]
        self._busy = np.zeros(self.n_servers, dtype=np.int64)  # reprolint: disable=R005 the port's ClusterState owns its eq. 2 vector
        self._busy_stale = False  # reprolint: disable=R005 the port's ClusterState owns its eq. 2 vector

    # ---- projections onto alive servers ---------------------------------

    def project(
        self, job: Job, per_group_remaining: dict[int, int]
    ) -> tuple[tuple[TaskGroup, ...], list[int]] | None:
        """(projected groups over alive servers, original gid per index);
        None if some non-empty group lost all replicas."""
        groups: list[TaskGroup] = []
        gids: list[int] = []
        for g, cnt in sorted(per_group_remaining.items()):
            if cnt <= 0:
                continue
            servers = self.live_servers(job.groups[g])
            if not servers:
                return None
            groups.append(TaskGroup(cnt, servers))
            gids.append(g)
        return tuple(groups), gids

    def problem_for(self, job: Job, groups: tuple[TaskGroup, ...]) -> AssignmentProblem:
        return AssignmentProblem(
            busy=self.busy_times(), mu=self.effective_mu(job), groups=groups
        )

    def outstanding(self) -> tuple[list[OutstandingJob], dict[int, list[int]]]:
        """Per-job remaining counts from queues, projected to alive servers."""
        rem: dict[int, dict[int, int]] = {}
        for m in range(self.n_servers):
            for seg in self.queues[m]:
                acc = rem.setdefault(seg.job_id, {})
                for g, cnt in seg.per_group.items():
                    acc[g] = acc.get(g, 0) + cnt
        out: list[OutstandingJob] = []
        gid_maps: dict[int, list[int]] = {}
        for job_id in sorted(rem):
            job = self.jobs[job_id]
            proj = self.project(job, rem[job_id])
            if proj is None:
                self.mark_failed(job_id)
                continue
            groups, gids = proj
            if groups:
                out.append(
                    OutstandingJob(
                        job_id=job_id, groups=groups, mu=self.effective_mu(job)
                    )
                )
                gid_maps[job_id] = gids
        return out, gid_maps

    # ---- slot processing -------------------------------------------------

    def process_slot(self) -> dict[int, int]:
        """One slot of head-of-queue service; returns tasks completed per job."""
        done: dict[int, int] = {}
        self.last_progress.fill(0)
        for m in range(self.n_servers):
            if not self.alive[m] or not self.queues[m]:
                continue
            seg = self.queues[m][0]
            mu = int(self.effective_mu(self.jobs[seg.job_id])[m])
            cost_before = -(-seg.total // mu)
            taken = seg.take(mu)
            if not self._busy_stale:
                self._busy[m] -= cost_before - (-(-seg.total // mu))  # reprolint: disable=R005 the port's ClusterState owns its eq. 2 vector
            if seg.total == 0:
                self.queues[m].popleft()
            if taken:
                done[seg.job_id] = done.get(seg.job_id, 0) + taken
                self.last_progress[m] = taken
                self.last_head_job[m] = seg.job_id
        return done

    # ---- invariant check (test hook) ------------------------------------

    def assert_invariant(self) -> None:
        """Every queued task sits on a server in its *original* group's
        locality set, per-job queued totals never exceed the remaining
        unprocessed count (task conservation), and the incremental busy
        vector matches the eq. 2 rescan."""
        queued: dict[int, int] = {}
        for m in range(self.n_servers):
            for seg in self.queues[m]:
                job = self.jobs[seg.job_id]
                for g, cnt in seg.per_group.items():
                    if g >= len(job.groups):
                        raise AssertionError(
                            f"job {seg.job_id}: unknown original group {g}"
                        )
                    if m not in job.groups[g].servers:
                        raise AssertionError(
                            f"job {seg.job_id} group {g}: task queued on "
                            f"server {m} outside locality set "
                            f"{job.groups[g].servers}"
                        )
                    if cnt <= 0:
                        raise AssertionError("empty segment entry survived")
                queued[seg.job_id] = queued.get(seg.job_id, 0) + seg.total
        for job_id, total in queued.items():
            rem = self.remaining.get(job_id)
            if rem is not None and total > rem:
                raise AssertionError(
                    f"job {job_id}: {total} tasks queued but only {rem} remain"
                )
        if not self._busy_stale and not np.array_equal(
            self._busy, self._rescan_busy()
        ):
            raise AssertionError(
                "incremental busy times diverged from the eq. 2 rescan"
            )
