"""Carry jobs and problems over from the reference package by duck typing.

The port and the reference each define their own ``Job``,
``TaskGroup`` and ``AssignmentProblem``.  These functions rebuild the
port's objects field for field from any objects with the same
attributes (``job_id``, ``arrival``, ``groups`` of ``size``/``servers``,
``mu``, ``busy``), as numpy arrays, without importing the reference.
Parity tests use them to feed both packages the same trace and the same
busy state.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np

from .core import AssignmentProblem, Job, TaskGroup

__all__ = ["from_reference_jobs", "from_reference_problem"]


def _groups(groups) -> tuple[TaskGroup, ...]:
    return tuple(
        TaskGroup(int(g.size), tuple(int(s) for s in g.servers)) for g in groups
    )


def from_reference_jobs(jobs: Iterable) -> list[Job]:
    """The port's :class:`~repro_torch.core.Job` for each reference job."""
    return [
        Job(
            job_id=int(j.job_id),
            arrival=int(j.arrival),
            groups=_groups(j.groups),
            mu=np.array(j.mu, copy=True),
        )
        for j in jobs
    ]


def from_reference_problem(problem) -> AssignmentProblem:
    """The port's :class:`~repro_torch.core.AssignmentProblem` for a
    reference problem (busy times, capacities and groups copied)."""
    return AssignmentProblem(
        busy=np.array(problem.busy, copy=True),
        mu=np.array(problem.mu, copy=True),
        groups=_groups(problem.groups),
    )
