"""Task assignment for the port: the paper's WF and the job orderings.

- :func:`water_filling` — the host K_c-approximate water-filling (a copy
  of the reference's, the oracle the device path is held against);
- :mod:`repro_torch.core.wf_torch` — water-filling with the water level
  on the card (registered as ``wf_torch``);
- :func:`reorder_schedule` — OCWF / OCWF-ACC job reordering.

``instance``, ``waterlevel``, ``bounds``, ``wf`` and ``reorder`` are
copies of the reference's modules of the same names.
"""

from .. import registry
from .bounds import phi_bounds, phi_minus, phi_plus
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


# module-level views of the registry's own storage
ALGORITHMS = registry.kind_dict("algorithm")
BATCH_ALGORITHMS = registry.kind_dict("batch_algorithm")

registry.register("algorithm", "wf", water_filling, overwrite=True)
registry.register("algorithm", "wf_torch", _wf_torch, overwrite=True)
# a native many-problems admission path: one call places a whole
# same-slot burst with eq. 2 commits between jobs
registry.register("batch_algorithm", "wf_torch", _wf_torch_chain, overwrite=True)

__all__ = [
    "ALGORITHMS",
    "BATCH_ALGORITHMS",
    "Assignment",
    "AssignmentProblem",
    "Job",
    "TaskGroup",
    "group_tasks",
    "phi_bounds",
    "phi_minus",
    "phi_plus",
    "OutstandingJob",
    "ReorderStats",
    "commit_busy",
    "priority_schedule",
    "reorder_schedule",
    "water_fill_alloc",
    "water_level",
    "water_filling",
    "wf_phi",
]
