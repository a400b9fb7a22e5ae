"""Water-filling task assignment (paper Sec. III-B, Alg. 2).

Assigns one task group at a time: for group ``k`` compute the minimal
integer level ``ξ_k`` satisfying eq. 9 over the *current* busy times
``b_m^c(k-1)``, give each participating server ``(ξ_k - b_m^c(k-1))·μ_m``
tasks (last participant takes the remainder), then raise busy times by
eq. 10.  Tight ``K_c``-approximate (Theorems 1-2); complexity
O(Σ_k |S_c^k| log |S_c^k|).
"""

from __future__ import annotations

import numpy as np

from .instance import Assignment, AssignmentProblem
from .waterlevel import water_fill_alloc, water_level

__all__ = ["water_filling", "wf_phi"]


def water_filling(problem: AssignmentProblem) -> Assignment:
    """Run WF; returns the assignment with ``phi = WF_{K_c}`` (eq. 15)."""
    busy = problem.busy.copy()  # b_m^c(k) evolves per group (eq. 10)
    alloc: list[dict[int, int]] = []
    phi = 0
    for g in problem.groups:
        srv = np.asarray(g.servers, dtype=np.int64)
        local_alloc, xi = water_fill_alloc(busy[srv], problem.mu[srv], g.size)
        per: dict[int, int] = {
            int(m): int(a) for m, a in zip(srv, local_alloc) if a > 0
        }
        alloc.append(per)
        # eq. 10: participating servers rise to ξ_k, others keep their level
        busy[srv] = np.maximum(busy[srv], xi)
        phi = max(phi, xi)
    result = Assignment(alloc=alloc, phi=int(phi))
    result.validate(problem)
    return result


def wf_phi(problem: AssignmentProblem) -> int:
    """Estimated completion time only (used by the reordering scan);
    skips the per-server allocation walk."""
    busy = problem.busy.copy()
    phi = 0
    for g in problem.groups:
        srv = np.asarray(g.servers, dtype=np.int64)
        xi = water_level(busy[srv], problem.mu[srv], g.size)
        busy[srv] = np.maximum(busy[srv], xi)
        phi = max(phi, xi)
    return int(phi)
