"""Task assignment for the port: the paper's algorithms and the orderings.

- :func:`obta` / :func:`nlip` — exact balanced assignment (max-flow
  oracle, with/without the ``[Φ^-, Φ^+]`` search-space narrowing);
- :func:`water_filling` — the host K_c-approximate water-filling (a copy
  of the reference's, the oracle the device path is held against);
- :mod:`repro_torch.core.wf_torch` — water-filling with the water level
  on the card (registered as ``wf_torch``);
- :func:`replica_deletion` — the host Replica-Deletion (registered as
  ``rd``; the oracle of the device RD);
- :mod:`repro_torch.core.rd_torch` — Replica-Deletion with its strips on
  the card (registered as ``rd_torch``);
- :mod:`repro_torch.core.rd_plus` — RD (on the card) then a host 1-opt
  polish (registered as ``rd_plus``);
- :func:`reorder_schedule` — OCWF / OCWF-ACC job reordering.

``instance``, ``waterlevel``, ``bounds``, ``flow``, ``obta``, ``wf``,
``reorder``, ``rd_reference`` and ``rd_plus`` are copies of the
reference's modules of the same names; ``rd`` is a copy of the host
parts of the reference's ``rd``.
"""

from .. import registry
from .bounds import phi_bounds, phi_minus, phi_plus
from .flow import feasible_assignment
from .instance import (
    Assignment,
    AssignmentProblem,
    Job,
    TaskGroup,
    group_tasks,
)
from .reorder import (
    OutstandingJob,
    ReorderStats,
    commit_busy,
    priority_schedule,
    reorder_schedule,
)
from .obta import nlip, obta, solve_exact
from .rd import replica_deletion
from .waterlevel import water_fill_alloc, water_level
from .wf import water_filling, wf_phi


def _wf_torch(problem: AssignmentProblem) -> Assignment:
    """Lazy import so the host algorithms load without the device path."""
    from .wf_torch import water_filling_torch

    return water_filling_torch(problem)


def _wf_torch_chain(problems: list[AssignmentProblem]) -> list[Assignment]:
    """Lazy import so the host algorithms load without the device path."""
    from .wf_torch import water_filling_torch_chain

    return water_filling_torch_chain(problems)


def _rd_torch(problem: AssignmentProblem) -> Assignment:
    """Lazy import so the host algorithms load without the device path."""
    from .rd_torch import replica_deletion_torch

    return replica_deletion_torch(problem)


def _rd_plus(problem: AssignmentProblem) -> Assignment:
    """Lazy import so the host algorithms load without the device path."""
    from .rd_plus import replica_deletion_plus

    return replica_deletion_plus(problem)


def _rd_torch_chain(problems: list[AssignmentProblem]) -> list[Assignment]:
    """Lazy import so the host algorithms load without the device path."""
    from .rd_torch import replica_deletion_torch_chain

    return replica_deletion_torch_chain(problems)


# module-level views of the registry's own storage
ALGORITHMS = registry.kind_dict("algorithm")
BATCH_ALGORITHMS = registry.kind_dict("batch_algorithm")

for _name, _fn in {
    "nlip": nlip,
    "obta": obta,
    "wf": water_filling,
    "wf_torch": _wf_torch,
    "rd": replica_deletion,
    "rd_torch": _rd_torch,
    "rd_plus": _rd_plus,
}.items():
    registry.register("algorithm", _name, _fn, overwrite=True)
del _name, _fn
# rd_plus has no batch path: its polish changes the assignment, so eq. 2
# is committed on the polished result between jobs (Policy's walk).
# native many-problems admission paths: one call places a whole
# same-slot burst with eq. 2 commits between jobs
registry.register("batch_algorithm", "wf_torch", _wf_torch_chain, overwrite=True)
registry.register("batch_algorithm", "rd_torch", _rd_torch_chain, overwrite=True)

__all__ = [
    "ALGORITHMS",
    "BATCH_ALGORITHMS",
    "Assignment",
    "AssignmentProblem",
    "Job",
    "TaskGroup",
    "group_tasks",
    "feasible_assignment",
    "nlip",
    "obta",
    "solve_exact",
    "phi_bounds",
    "phi_minus",
    "phi_plus",
    "OutstandingJob",
    "ReorderStats",
    "commit_busy",
    "priority_schedule",
    "reorder_schedule",
    "replica_deletion",
    "water_fill_alloc",
    "water_level",
    "water_filling",
    "wf_phi",
]
