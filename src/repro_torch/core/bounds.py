"""Search-space narrowing for ``Φ_c`` (paper Sec. III-A2, eqs. 5-7)."""

from __future__ import annotations

import numpy as np

from .instance import AssignmentProblem
from .waterlevel import water_level

__all__ = ["phi_plus", "phi_minus", "phi_bounds"]


def phi_plus(problem: AssignmentProblem) -> int:
    """Upper bound Φ_c^+ (eq. 5): every available server takes all its
    reachable tasks."""
    load = np.zeros(problem.n_servers, dtype=np.int64)
    for g in problem.groups:
        for m in g.servers:
            load[m] += g.size
    avail = np.asarray(problem.available_servers, dtype=np.int64)
    b = problem.busy[avail]
    mu = problem.mu[avail]
    return int((b + -(-load[avail] // mu)).max())


def phi_minus(problem: AssignmentProblem) -> int:
    """Lower bound Φ_c^- (eqs. 6-7): max over groups of the per-group
    water level ``x_k`` as if it were the only group."""
    best = 0
    for g in problem.groups:
        srv = np.asarray(g.servers, dtype=np.int64)
        xk = water_level(problem.busy[srv], problem.mu[srv], g.size)
        best = max(best, xk)
    return best


def phi_bounds(problem: AssignmentProblem) -> tuple[int, int]:
    lo, hi = phi_minus(problem), phi_plus(problem)
    if lo > hi:  # cannot happen for consistent instances; clamp defensively
        lo = hi
    return lo, hi
