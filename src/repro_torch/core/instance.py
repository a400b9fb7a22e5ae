"""Problem instances for data-locality-aware task assignment.

Terminology follows the paper (Sec. II):

- ``M`` servers, indexed ``0..M-1`` (the paper uses 1-based indices).
- A *job* ``c`` consists of tasks, each demanding one data chunk; the set of
  servers holding a task's chunk is its *available servers* ``S^r``.
- Tasks sharing the same available-server set form a *task group*
  ``T_c^k`` with server set ``S_c^k`` (eq. 3).
- ``mu[m]`` (``μ_m^c``): number of job-``c`` tasks server ``m`` processes per
  time slot.
- ``busy[m]`` (``b_m^c``): estimated busy time of server ``m`` just before the
  job arrives (eq. 2), in integer time slots.

An :class:`AssignmentProblem` is exactly the paper's arrival instance
``I(c, {b_m^c}_m)``; every algorithm in :mod:`repro_torch.core` consumes one and
produces an :class:`Assignment`.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Iterable, Mapping, Sequence

import numpy as np

__all__ = [
    "TaskGroup",
    "Job",
    "AssignmentProblem",
    "Assignment",
    "group_tasks",
]


@dataclasses.dataclass(frozen=True)
class TaskGroup:
    """A set of tasks sharing the same available-server set ``S_c^k``."""

    size: int
    servers: tuple[int, ...]  # sorted, unique server ids

    def __post_init__(self) -> None:
        if self.size <= 0:
            raise ValueError(f"task group must be non-empty, got size={self.size}")
        if not self.servers:
            raise ValueError("task group must have at least one available server")
        srv = tuple(sorted(set(self.servers)))
        if srv != self.servers:
            object.__setattr__(self, "servers", srv)


@dataclasses.dataclass(frozen=True)
class Job:
    """An arriving job: task groups + per-server capacity ``μ_m^c``."""

    job_id: int
    arrival: int  # arrival time slot
    groups: tuple[TaskGroup, ...]
    mu: np.ndarray  # (M,) int, per-server tasks/slot for this job

    @property
    def n_tasks(self) -> int:
        return sum(g.size for g in self.groups)

    @property
    def available_servers(self) -> tuple[int, ...]:
        out: set[int] = set()
        for g in self.groups:
            out.update(g.servers)
        return tuple(sorted(out))

    def subset(self, remaining: Sequence[int]) -> "Job":
        """Job with per-group task counts replaced by ``remaining`` (drop empties)."""
        if len(remaining) != len(self.groups):
            raise ValueError("remaining must align with groups")
        groups = tuple(
            TaskGroup(int(r), g.servers)
            for g, r in zip(self.groups, remaining)
            if int(r) > 0
        )
        return dataclasses.replace(self, groups=groups)


@dataclasses.dataclass(frozen=True)
class AssignmentProblem:
    """The paper's arrival instance ``I = I(c, {b_m^c}_m)``."""

    busy: np.ndarray  # (M,) int — b_m^c, estimated busy times (eq. 2)
    mu: np.ndarray  # (M,) int — μ_m^c
    groups: tuple[TaskGroup, ...]

    def __post_init__(self) -> None:
        busy = np.asarray(self.busy, dtype=np.int64)
        mu = np.asarray(self.mu, dtype=np.int64)
        if busy.shape != mu.shape or busy.ndim != 1:
            raise ValueError("busy and mu must be 1-D arrays of equal length")
        if np.any(mu <= 0):
            raise ValueError("all server capacities must be positive")
        if np.any(busy < 0):
            raise ValueError("busy times must be non-negative")
        object.__setattr__(self, "busy", busy)
        object.__setattr__(self, "mu", mu)
        m = busy.shape[0]
        for g in self.groups:
            if g.servers[-1] >= m or g.servers[0] < 0:
                raise ValueError(f"group references server out of range 0..{m - 1}")

    @property
    def n_servers(self) -> int:
        return int(self.busy.shape[0])

    @property
    def n_tasks(self) -> int:
        return sum(g.size for g in self.groups)

    @property
    def available_servers(self) -> tuple[int, ...]:
        out: set[int] = set()
        for g in self.groups:
            out.update(g.servers)
        return tuple(sorted(out))

    @classmethod
    def from_job(cls, job: Job, busy: np.ndarray) -> "AssignmentProblem":
        return cls(busy=busy, mu=job.mu, groups=job.groups)


@dataclasses.dataclass
class Assignment:
    """Result of a task-assignment algorithm.

    ``alloc[k][m]`` is the number of group-``k`` tasks assigned to server
    ``m``; ``phi`` is the algorithm's estimated completion time ``Φ_c``
    (in absolute time slots, comparable to busy times).
    """

    alloc: list[dict[int, int]]
    phi: int

    def server_loads(self, n_servers: int) -> np.ndarray:
        loads = np.zeros(n_servers, dtype=np.int64)
        for per_server in self.alloc:
            for m, cnt in per_server.items():
                loads[m] += cnt
        return loads

    def realized_phi(self, problem: AssignmentProblem) -> int:
        """Physical completion time: ``max_m b_m + ceil(load_m / μ_m)``.

        This matches the simulator's FIFO cost model (eq. 2 charges
        ``ceil(o_m^h / μ_m^h)`` per job) and is the quantity the paper's
        objective actually realizes.
        """
        loads = self.server_loads(problem.n_servers)
        used = loads > 0
        if not used.any():
            return int(problem.busy.max(initial=0))
        b = problem.busy[used]
        ceil_slots = -(-loads[used] // problem.mu[used])
        return int((b + ceil_slots).max())

    def validate(self, problem: AssignmentProblem) -> None:
        """Raise if the assignment violates locality or task conservation."""
        if len(self.alloc) != len(problem.groups):
            raise AssertionError("alloc must have one entry per task group")
        for k, (g, per_server) in enumerate(zip(problem.groups, self.alloc)):
            total = 0
            allowed = set(g.servers)
            for m, cnt in per_server.items():
                if cnt < 0:
                    raise AssertionError(f"negative count at group {k} server {m}")
                if cnt > 0 and m not in allowed:
                    raise AssertionError(
                        f"locality violation: group {k} task on server {m}"
                    )
                total += cnt
            if total != g.size:
                raise AssertionError(
                    f"group {k}: assigned {total} of {g.size} tasks"
                )


def group_tasks(
    task_servers: Iterable[Sequence[int]],
) -> tuple[TaskGroup, ...]:
    """Build task groups from per-task available-server lists (eq. 3)."""
    counts: Mapping[tuple[int, ...], int] = defaultdict(int)
    for servers in task_servers:
        counts[tuple(sorted(set(servers)))] += 1
    return tuple(
        TaskGroup(size, servers) for servers, size in sorted(counts.items())
    )
