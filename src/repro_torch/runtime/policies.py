"""Pluggable scheduling policies: {assignment algorithm} × {job ordering}.

A copy of ``repro/runtime/policies.py`` over the port's registry.  A
:class:`Policy` bundles the two axes the paper evaluates:

- **assignment** — how one job's task groups are placed given busy
  times (the host ``wf``, or ``wf_torch`` with the water level on the
  card; paper Sec. III);
- **ordering** — what happens to the *outstanding* job set on each
  arrival (paper Sec. IV):

  - ``fifo``     — new job is appended; nothing is reshuffled;
  - ``ocwf``     — full shortest-estimated-time-first rescan (Alg. 3);
  - ``ocwf-acc`` — OCWF with the ``Φ^-`` early-exit (same schedule,
    fewer WF evaluations);
  - ``setf``     — shortest *elapsed* (attained) service first.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Protocol, runtime_checkable

from .. import registry
from ..core import (
    ALGORITHMS,
    Assignment,
    AssignmentProblem,
    OutstandingJob,
    ReorderStats,
    commit_busy,
    priority_schedule,
    reorder_schedule,
)

__all__ = [
    "AssignFn",
    "BatchAssignFn",
    "SchedulingPolicy",
    "Policy",
    "ORDERINGS",
    "get_assigner",
    "make_policy",
    "list_policies",
]

AssignFn = Callable[[AssignmentProblem], Assignment]
BatchAssignFn = Callable[[list[AssignmentProblem]], list[Assignment]]

ORDERINGS = ("fifo", "ocwf", "ocwf-acc", "setf")

for _o, _desc in {
    "fifo": "append arrivals; never reshuffle outstanding jobs",
    "ocwf": "full shortest-estimated-time-first rescan (Alg. 3)",
    "ocwf-acc": "OCWF with the Phi^- early-exit (same schedule)",
    "setf": "shortest attained service first (static priority)",
}.items():
    registry.register("ordering", _o, _desc, overwrite=True)
del _o, _desc


@runtime_checkable
class SchedulingPolicy(Protocol):
    """What the engine requires of a policy."""

    name: str

    @property
    def reorders(self) -> bool:
        """True if arrivals trigger a full reschedule of outstanding jobs."""
        ...

    def assign(self, problem: AssignmentProblem) -> Assignment:
        """Place one job's task groups given current busy times."""
        ...

    def assign_batch(self, problems: list[AssignmentProblem]) -> list[Assignment]:
        """Place a same-slot burst of jobs, in order, committing eq. 2
        between jobs (identical to sequential :meth:`assign` calls)."""
        ...

    def schedule(
        self,
        outstanding: list[OutstandingJob],
        n_servers: int,
        *,
        attained: dict[int, int] | None = None,
    ) -> tuple[list[tuple[int, Assignment]], ReorderStats]:
        """Re-order and re-assign the whole outstanding set (reorder mode)."""
        ...


@dataclasses.dataclass(frozen=True)
class Policy:
    """Concrete :class:`SchedulingPolicy` built from registered parts."""

    name: str
    assigner: AssignFn
    ordering: str = "fifo"
    batch_assigner: BatchAssignFn | None = None

    def __post_init__(self) -> None:
        if self.ordering not in ORDERINGS:
            raise ValueError(
                f"unknown ordering {self.ordering!r}; expected one of {ORDERINGS}"
            )

    @property
    def reorders(self) -> bool:
        return self.ordering != "fifo"

    def assign(self, problem: AssignmentProblem) -> Assignment:
        return self.assigner(problem)

    def assign_batch(self, problems: list[AssignmentProblem]) -> list[Assignment]:
        """Admit a same-slot burst; identical to sequential :meth:`assign`.

        With a registered ``batch_assigner`` (``wf_torch``) the whole
        burst is one chained device pass; otherwise each job is assigned
        against the busy vector its predecessors left (eq. 2 commit).
        """
        if self.batch_assigner is not None and len(problems) > 1:
            return self.batch_assigner(problems)
        out: list[Assignment] = []
        busy = None
        for prob in problems:
            if busy is not None:
                prob = dataclasses.replace(prob, busy=busy)
            assignment = self.assigner(prob)
            out.append(assignment)
            busy = commit_busy(prob.busy, assignment, prob.mu, prob.n_servers)
        return out

    def schedule(
        self,
        outstanding: list[OutstandingJob],
        n_servers: int,
        *,
        attained: dict[int, int] | None = None,
    ) -> tuple[list[tuple[int, Assignment]], ReorderStats]:
        if self.ordering in ("ocwf", "ocwf-acc"):
            return reorder_schedule(
                outstanding,
                n_servers,
                accelerated=self.ordering == "ocwf-acc",
                assigner=self.assigner,
            )
        if self.ordering == "setf":
            served = attained or {}
            return priority_schedule(
                outstanding,
                n_servers,
                key=lambda j: (served.get(j.job_id, 0), j.job_id),
                assigner=self.assigner,
            )
        raise ValueError(f"ordering {self.ordering!r} does not reschedule")


def get_assigner(name: str) -> AssignFn:
    """Resolve a registered assignment algorithm by name."""
    return registry.resolve("algorithm", name)


def make_policy(assign: str = "wf", ordering: str = "fifo") -> Policy:
    """Build a policy from registered names, e.g. ``make_policy("wf_torch")``
    or ``make_policy("wf", "ocwf-acc")``."""
    name = assign if ordering == "fifo" else f"{assign}+{ordering}"
    batch = (
        registry.resolve("batch_algorithm", assign)
        if registry.contains("batch_algorithm", assign)
        else None
    )
    return Policy(
        name=name,
        assigner=get_assigner(assign),
        ordering=ordering,
        batch_assigner=batch,
    )


def list_policies() -> list[str]:
    """Names of all registered assignment algorithms."""
    return sorted(ALGORITHMS)
