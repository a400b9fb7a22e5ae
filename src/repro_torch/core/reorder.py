"""Job reordering: OCWF and OCWF-ACC (paper Sec. IV, Alg. 3).

On every job arrival the whole set of outstanding jobs ``O_c`` is re-ordered
into ``Q_c`` following shortest-estimated-time-first: repeatedly pick the
job whose remaining tasks, assigned by WF on top of the already-ordered
jobs' busy times, finish earliest.

OCWF evaluates WF for *every* remaining candidate at every position.
OCWF-ACC first computes the cheap lower bound ``Φ^-`` (eqs. 6-7) for each
candidate, walks candidates in ascending ``(Φ^-, job_id)`` order and stops
as soon as the next lower bound cannot beat the best exact ``Φ`` found —
the paper's *early-exit*.  Both variants walk candidates in the same order
and tie-break identically, so they produce the same schedule (as in the
paper's Table I); only the number of WF evaluations differs.

Busy-time commits between positions follow eq. 2 exactly:
``b_m += ⌈assigned_m / μ_m^l⌉`` for the selected job ``l``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from .bounds import phi_minus
from .instance import Assignment, AssignmentProblem, Job, TaskGroup
from .wf import water_filling, wf_phi

__all__ = [
    "OutstandingJob",
    "ReorderStats",
    "commit_busy",
    "reorder_schedule",
    "priority_schedule",
]


@dataclasses.dataclass(frozen=True)
class OutstandingJob:
    """A job with only its *unprocessed* tasks (groups already filtered)."""

    job_id: int
    groups: tuple[TaskGroup, ...]
    mu: np.ndarray  # (M,) per-server capacity for this job


@dataclasses.dataclass
class ReorderStats:
    """Work counters for the overhead comparison (OCWF vs OCWF-ACC)."""

    wf_evals: int = 0
    bound_evals: int = 0
    positions: int = 0


def commit_busy(
    busy: np.ndarray, assignment: Assignment, mu: np.ndarray, n_servers: int
) -> np.ndarray:
    """eq. 2 commit: raise each used server's busy time by ⌈assigned/μ⌉."""
    loads = assignment.server_loads(n_servers)
    used = loads > 0
    busy = busy.copy()
    busy[used] += -(-loads[used] // mu[used])
    return busy


_commit_busy = commit_busy  # historical private name


def reorder_schedule(
    jobs: list[OutstandingJob],
    n_servers: int,
    *,
    accelerated: bool = True,
    assigner: Callable[[AssignmentProblem], Assignment] = water_filling,
) -> tuple[list[tuple[int, Assignment]], ReorderStats]:
    """Order ``jobs`` and assign their tasks; returns (schedule, stats).

    ``schedule`` lists ``(job_id, assignment)`` in execution order; server
    queues should be rebuilt in exactly this order.
    """
    stats = ReorderStats()
    busy = np.zeros(n_servers, dtype=np.int64)
    remaining = {j.job_id: j for j in jobs}
    schedule: list[tuple[int, Assignment]] = []

    while remaining:
        stats.positions += 1
        cands = sorted(remaining.values(), key=lambda j: j.job_id)
        # lower bounds are cheap (water level per group); compute for all
        bounds = []
        for j in cands:
            prob = AssignmentProblem(busy=busy, mu=j.mu, groups=j.groups)
            bounds.append(phi_minus(prob))
            stats.bound_evals += 1
        order = sorted(range(len(cands)), key=lambda i: (bounds[i], cands[i].job_id))

        best_job: OutstandingJob | None = None
        best_phi = 0
        for i in order:
            j = cands[i]
            if best_job is not None and accelerated and bounds[i] >= best_phi:
                break  # early-exit: no later candidate can strictly improve
            prob = AssignmentProblem(busy=busy, mu=j.mu, groups=j.groups)
            phi = wf_phi(prob)
            stats.wf_evals += 1
            if best_job is None or phi < best_phi:
                best_job, best_phi = j, phi

        assert best_job is not None
        prob = AssignmentProblem(busy=busy, mu=best_job.mu, groups=best_job.groups)
        assignment = assigner(prob)
        busy = _commit_busy(busy, assignment, best_job.mu, n_servers)
        schedule.append((best_job.job_id, assignment))
        del remaining[best_job.job_id]

    return schedule, stats


def priority_schedule(
    jobs: list[OutstandingJob],
    n_servers: int,
    *,
    key: Callable[[OutstandingJob], tuple],
    assigner: Callable[[AssignmentProblem], Assignment] = water_filling,
) -> tuple[list[tuple[int, Assignment]], ReorderStats]:
    """Assign jobs in a *static* priority order (e.g. SETF).

    Unlike :func:`reorder_schedule` there is no per-position WF scan: the
    order is fixed up front by ``key`` (ascending), so scheduling costs one
    assignment per job.  Busy-time commits between positions follow eq. 2,
    identical to the OCWF walk.
    """
    stats = ReorderStats()
    busy = np.zeros(n_servers, dtype=np.int64)
    schedule: list[tuple[int, Assignment]] = []
    for j in sorted(jobs, key=key):
        stats.positions += 1
        prob = AssignmentProblem(busy=busy, mu=j.mu, groups=j.groups)
        assignment = assigner(prob)
        stats.wf_evals += 1
        busy = _commit_busy(busy, assignment, j.mu, n_servers)
        schedule.append((j.job_id, assignment))
    return schedule, stats


def job_to_outstanding(job: Job, remaining_per_group: list[int]) -> OutstandingJob:
    """Project a job onto its unprocessed tasks (drop exhausted groups)."""
    groups = tuple(
        TaskGroup(int(r), g.servers)
        for g, r in zip(job.groups, remaining_per_group)
        if int(r) > 0
    )
    return OutstandingJob(job_id=job.job_id, groups=groups, mu=job.mu)
