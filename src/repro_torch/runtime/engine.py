"""The scheduling engine: drives job traces through a cluster under a policy.

The slot loop of ``repro/runtime/engine.py``.  Time is divided into
identical slots, servers hold FIFO queues of outstanding job tasks, and
server ``m`` processes up to ``μ_m^h`` tasks of its *head* job per slot,
so the backlog cost is ``⌈o_m^h/μ_m^h⌉`` per queued job — eq. 2 by
construction.

Arrivals sharing a slot are admitted as one *burst*: FIFO policies place
the whole burst through :meth:`SchedulingPolicy.assign_batch` (for
``wf_torch`` that is one chained device pass), with results identical to
per-arrival admission.  Reordering policies (OCWF, OCWF-ACC, SETF)
re-order and re-assign the whole outstanding set, folding a same-slot
burst into one rescan (task totals are conserved within the slot, so the
final reschedule subsumes the intermediate ones).

Fault events, placement, the event-stepped control plane and
observability belong to later slices of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from ..core import AssignmentProblem, Job, OutstandingJob
from ..obs import clock
from .cluster import ClusterState
from .policies import Policy, SchedulingPolicy, make_policy

__all__ = ["SchedulingEngine", "SimResult"]


@dataclasses.dataclass
class SimResult:
    """Outcome of one run.  Jobs partition into completed (``jct``) and
    failed (``failed_jobs``: data loss); JCT statistics are over
    completed jobs only."""

    jct: dict[int, int]  # job_id -> completion time (slots)
    overhead_s: list[float]  # per-arrival scheduling wall time
    makespan: int
    failed_jobs: list[int]  # jobs whose data became unavailable

    @property
    def mean_jct(self) -> float:
        return float(np.mean(list(self.jct.values()))) if self.jct else float("nan")

    @property
    def mean_overhead_s(self) -> float:
        return float(np.mean(self.overhead_s)) if self.overhead_s else 0.0

    def jct_percentile(self, q: float) -> float:
        if not self.jct:
            return float("nan")
        return float(np.percentile(list(self.jct.values()), q))


class SchedulingEngine:
    """Drives a trace of :class:`repro_torch.core.Job` under a policy.

    ``debug=True`` validates every assignment on every enqueue path and
    cross-checks the incremental busy-time vector against the eq. 2
    rescan.  ``batch_arrivals=False`` forces per-arrival admission.
    """

    def __init__(
        self,
        n_servers: int,
        policy: SchedulingPolicy | Policy | str = "wf",
        *,
        max_slots: int = 10_000_000,
        on_slot: Callable[[ClusterState, int], None] | None = None,
        debug: bool = False,
        batch_arrivals: bool = True,
    ):
        self.n_servers = n_servers
        self.policy = make_policy(policy) if isinstance(policy, str) else policy
        self.max_slots = max_slots
        self.on_slot = on_slot  # test hook, called once per slot
        self.debug = debug
        self.batch_arrivals = batch_arrivals
        self.cluster: ClusterState | None = None  # populated by run()

    # ---- reordering ------------------------------------------------------

    def _attained(self) -> dict[int, int]:
        """Tasks already processed per live job (SETF's elapsed service)."""
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

    # ---- arrivals --------------------------------------------------------

    def _admit_one(self, job: Job) -> float | None:
        """Place one arriving job; returns scheduling wall time (None if
        the job's data is already unavailable)."""
        cluster = self.cluster
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
        return clock.perf_counter() - t0

    def _project_batch(self, batch: list[Job]) -> list[tuple[Job, tuple, list[int]]]:
        """Project each burst job onto alive servers; jobs whose data is
        gone are marked failed and dropped.  Returns (job, groups, gids)."""
        cluster = self.cluster
        admitted: list[tuple[Job, tuple, list[int]]] = []
        for job in batch:
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
        one call; reordering policies fold the burst into ONE rescan.  A
        burst of one takes the per-arrival path.  Each burst job's
        recorded overhead is the burst's wall time over its size.
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
        return [elapsed / len(admitted)] * len(admitted)

    def _admit_burst_reorder(self, batch: list[Job]) -> list[float]:
        """Fold a same-slot burst into a single reordering rescan: only
        the last per-arrival rescan would decide the realized schedule."""
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
        return [elapsed / len(extras)] * len(extras)

    # ---- main loop -------------------------------------------------------

    def run(self, jobs: list[Job]) -> SimResult:
        self.cluster = cluster = ClusterState(
            self.n_servers, {j.job_id: j for j in jobs}, debug=self.debug
        )
        arrivals = sorted(jobs, key=lambda j: (j.arrival, j.job_id))
        jct: dict[int, int] = {}
        overheads: list[float] = []
        ai = slot = 0
        while slot < self.max_slots:
            batch: list[Job] = []
            while ai < len(arrivals) and arrivals[ai].arrival <= slot:
                job = arrivals[ai]
                ai += 1
                if job.n_tasks == 0:
                    jct[job.job_id] = 0  # empty job completes at arrival
                    continue
                batch.append(job)
            if batch:
                overheads.extend(self._admit_burst(batch))
            for job_id, n_done in cluster.process_slot().items():
                if job_id not in cluster.remaining:
                    continue
                cluster.remaining[job_id] -= n_done
                if cluster.remaining[job_id] <= 0:
                    job = cluster.jobs[job_id]
                    jct[job_id] = slot + 1 - job.arrival
                    del cluster.remaining[job_id]
            if self.on_slot is not None:
                self.on_slot(cluster, slot)
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
        )
