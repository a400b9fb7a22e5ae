"""RD+ — replica-deletion with a 1-opt rebalancing polish (beyond-paper).

The paper's RD deletes replicas by max-copy-count first, which can strand a
task's last replica on a server with a large initial backlog (the copy
count says nothing about *where* the survivors sit).  RD+ runs RD, then
applies a cheap local-search repair on the realized busy times:

    while the makespan server has a task that fits strictly below the
    current makespan on another of its available servers, move one
    slot's worth of its tasks there.

Each move strictly reduces (max_busy, #servers_at_max) lexicographically,
so the descent terminates; every move respects data locality by
construction (moves only along a group's available-server set).

This is the reference's improvement on the paper — ``rd`` (faithful)
and ``rd_plus`` are reported apart.  The port's copy of
``repro/core/rd_plus.py``: its RD phase is the device RD,
:func:`~repro_torch.core.rd_torch.replica_deletion_torch` (the step
kernel on the card, its plain iteration for a ``device="cpu"`` scope),
which is assignment-identical to the host RD the reference's CPU path
runs; the polish stays on the host.  Registered as ``rd_plus``.
"""

from __future__ import annotations

import numpy as np

from .instance import Assignment, AssignmentProblem
from .rd_torch import replica_deletion_torch

__all__ = ["replica_deletion_plus", "rebalance_1opt"]


def rebalance_1opt(
    problem: AssignmentProblem, assignment: Assignment, max_rounds: int = 10_000
) -> Assignment:
    """Greedy 1-opt descent on realized busy times; locality-preserving."""
    n = problem.n_servers
    loads = assignment.server_loads(n)
    alloc = [dict(per) for per in assignment.alloc]
    mu = problem.mu
    busy0 = problem.busy

    def fin(m: int) -> int:
        if loads[m] == 0:
            return int(busy0[m])
        return int(busy0[m] + -(-loads[m] // mu[m]))

    fin_vec = np.array([fin(m) for m in range(n)], dtype=np.int64)
    group_srv = [np.asarray(g.servers, dtype=np.int64) for g in problem.groups]
    for _ in range(max_rounds):
        used = loads > 0
        if not used.any():
            break
        top = int(fin_vec[used].max())
        movers = np.flatnonzero(used & (fin_vec == top))
        moved = False
        for m_src in movers:
            # tasks to shed: enough to drop one slot at the source
            shed = ((int(loads[m_src]) - 1) % int(mu[m_src])) + 1
            # candidate (group, destination) pairs: any group with tasks on
            # m_src may move to another available server that stays < top;
            # all of a group's destinations are scored in one vector op and
            # the first valid one (in available-server order) is taken
            for k, per in enumerate(alloc):
                have = per.get(int(m_src), 0)
                if have <= 0:
                    continue
                take = min(have, shed)
                srv = group_srv[k]
                new_fin = busy0[srv] + -(-(loads[srv] + take) // mu[srv])
                valid = (new_fin < top) & (srv != m_src)
                if not valid.any():
                    continue
                m_dst = int(srv[np.argmax(valid)])
                per[int(m_src)] = have - take
                if per[int(m_src)] == 0:
                    del per[int(m_src)]
                per[m_dst] = per.get(m_dst, 0) + take
                loads[m_src] -= take
                loads[m_dst] += take
                fin_vec[m_src] = fin(int(m_src))
                fin_vec[m_dst] = fin(m_dst)
                moved = True
                break
            if moved:
                break
        if not moved:
            break
    out = Assignment(alloc=alloc, phi=0)
    out.phi = out.realized_phi(problem)
    out.validate(problem)
    return out


def replica_deletion_plus(problem: AssignmentProblem) -> Assignment:
    """RD on the device (one ``rd_torch`` call, no batch path: eq. 2 is
    committed on the polished result between jobs), then the host 1-opt
    polish."""
    return rebalance_1opt(problem, replica_deletion_torch(problem))
