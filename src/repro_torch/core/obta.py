"""Exact balanced task assignment: OBTA and the NLIP baseline (Sec. III-A).

The port's copy of ``repro/core/obta.py``, on the host (registered as
the algorithms ``obta`` and ``nlip``).

The paper solves program ``P`` (eq. 4) with CPLEX; OBTA's contribution is to
narrow the search space of ``Φ_c`` to ``[Φ_c^-, Φ_c^+]`` and split it into
sub-intervals at the sorted busy times (Fig. 1) so each piece is a *linear*
integer program.  Offline we have no solver, so each piece is decided by an
exact Dinic max-flow feasibility oracle instead (:mod:`.flow`); feasibility
is monotone in ``Φ``, making each sub-interval a binary search.

Both solvers are exact; they differ only in the searched space:

- ``NLIP``: scans sub-intervals of ``[1, Φ_c^+]`` (no narrowing) — the
  paper's baseline that "solves P directly".
- ``OBTA``: scans sub-intervals of ``[Φ_c^-, Φ_c^+]`` — skipping everything
  below the water-level lower bound, which is where the ~2× overhead saving
  comes from (paper Figs. 10-12).
"""

from __future__ import annotations

import numpy as np

from .bounds import phi_bounds, phi_plus
from .flow import feasible_assignment
from .instance import Assignment, AssignmentProblem

__all__ = ["solve_exact", "obta", "nlip"]


def _min_feasible_in(
    problem: AssignmentProblem, lo: int, hi: int
) -> Assignment | None:
    """Binary search the minimal feasible ``Φ`` in ``[lo, hi]`` (monotone)."""
    if lo > hi:
        return None
    best: Assignment | None = feasible_assignment(problem, hi)
    if best is None:
        return None
    while lo < hi:
        mid = (lo + hi) // 2
        cand = feasible_assignment(problem, mid)
        if cand is not None:
            best, hi = cand, mid
        else:
            lo = mid + 1
    return best


def solve_exact(problem: AssignmentProblem, *, narrow: bool = True) -> Assignment:
    """Solve ``P`` exactly.  ``narrow=True`` → OBTA; ``False`` → NLIP.

    Sub-interval scan per Sec. III-A3: sort busy times of available servers,
    walk the induced sub-intervals in ascending order, and return the first
    solvable one (no later interval can contain a smaller ``Φ``).
    """
    lo_bound, hi_bound = phi_bounds(problem)
    if not narrow:
        lo_bound = 1
        hi_bound = phi_plus(problem)
    avail = np.asarray(problem.available_servers, dtype=np.int64)
    cuts = np.unique(problem.busy[avail])
    cuts = cuts[(cuts > lo_bound) & (cuts <= hi_bound)]
    # sub-intervals: [lo_bound, c1-1], [c1, c2-1], ..., [ck, hi_bound]
    edges = [lo_bound, *[int(c) for c in cuts], hi_bound + 1]
    for i in range(len(edges) - 1):
        lo, hi = edges[i], edges[i + 1] - 1
        result = _min_feasible_in(problem, lo, hi)
        if result is not None:
            result.validate(problem)
            return result
    raise AssertionError(
        "P must be feasible at Φ_c^+ by construction (eq. 5)"
    )


def obta(problem: AssignmentProblem) -> Assignment:
    """Optimal Balanced Task Assignment (paper Alg. 1)."""
    return solve_exact(problem, narrow=True)


def nlip(problem: AssignmentProblem) -> Assignment:
    """Exact solve without search-space narrowing (paper's NLIP baseline)."""
    return solve_exact(problem, narrow=False)
