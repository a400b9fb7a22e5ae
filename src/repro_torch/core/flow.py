"""Dinic max-flow on the task-assignment bipartite network.

The port's copy of ``repro/core/flow.py``, which replaces the CPLEX
solver of the paper.  For a candidate completion time ``Φ``, job ``c``'s
tasks can all finish by ``Φ`` iff the following network admits a flow of
value ``|T_c|``:

    source ──|T_c^k|──► group k ──∞──► server m ──max{Φ-b_m,0}·μ_m──► sink
                                  (edge iff m ∈ S_c^k)

Flow integrality gives an integral task assignment.  Graphs are tiny
(K groups × ~M servers), so a pure-Python Dinic is plenty fast; feasibility
is monotone in ``Φ`` which the exact solvers exploit via binary search.
"""

from __future__ import annotations

import numpy as np

from .instance import Assignment, AssignmentProblem

__all__ = ["Dinic", "feasible_assignment", "capacity_at"]

_INF = 1 << 60


class Dinic:
    """Standard Dinic max-flow with adjacency lists."""

    def __init__(self, n: int) -> None:
        self.n = n
        self.head: list[list[int]] = [[] for _ in range(n)]
        # edges stored flat: to[i], cap[i]; reverse edge is i ^ 1
        self.to: list[int] = []
        self.cap: list[int] = []

    def add_edge(self, u: int, v: int, cap: int) -> int:
        idx = len(self.to)
        self.to.append(v)
        self.cap.append(cap)
        self.head[u].append(idx)
        self.to.append(u)
        self.cap.append(0)
        self.head[v].append(idx + 1)
        return idx

    def _bfs(self, s: int, t: int) -> bool:
        self.level = [-1] * self.n
        self.level[s] = 0
        queue = [s]
        for u in queue:
            for eid in self.head[u]:
                v = self.to[eid]
                if self.cap[eid] > 0 and self.level[v] < 0:
                    self.level[v] = self.level[u] + 1
                    queue.append(v)
        return self.level[t] >= 0

    def _dfs(self, u: int, t: int, f: int) -> int:
        if u == t:
            return f
        while self.iter[u] < len(self.head[u]):
            eid = self.head[u][self.iter[u]]
            v = self.to[eid]
            if self.cap[eid] > 0 and self.level[v] == self.level[u] + 1:
                d = self._dfs(v, t, min(f, self.cap[eid]))
                if d > 0:
                    self.cap[eid] -= d
                    self.cap[eid ^ 1] += d
                    return d
            self.iter[u] += 1
        return 0

    def max_flow(self, s: int, t: int, limit: int = _INF) -> int:
        flow = 0
        while flow < limit and self._bfs(s, t):
            self.iter = [0] * self.n
            while True:
                f = self._dfs(s, t, limit - flow)
                if f == 0:
                    break
                flow += f
        return flow


def capacity_at(problem: AssignmentProblem, phi: int) -> np.ndarray:
    """Per-server task capacity ``max{Φ - b_m, 0}·μ_m`` at completion Φ."""
    return np.maximum(phi - problem.busy, 0) * problem.mu


def feasible_assignment(
    problem: AssignmentProblem, phi: int
) -> Assignment | None:
    """Assignment finishing by ``phi`` if one exists, else ``None``.

    Runs one Dinic max-flow; O(V²E) worst case on a graph with
    K + |available servers| + 2 nodes.
    """
    groups = problem.groups
    k_n = len(groups)
    servers = problem.available_servers
    srv_index = {m: i for i, m in enumerate(servers)}
    n_nodes = 2 + k_n + len(servers)
    src, snk = 0, n_nodes - 1
    g = Dinic(n_nodes)
    total = 0
    cap = capacity_at(problem, phi)
    group_edges: list[list[tuple[int, int]]] = []  # per group: (edge_id, server)
    for k, grp in enumerate(groups):
        g.add_edge(src, 1 + k, grp.size)
        total += grp.size
        edges = []
        for m in grp.servers:
            eid = g.add_edge(1 + k, 1 + k_n + srv_index[m], grp.size)
            edges.append((eid, m))
        group_edges.append(edges)
    for m in servers:
        g.add_edge(1 + k_n + srv_index[m], snk, int(cap[m]))
    if g.max_flow(src, snk, total) < total:
        return None
    alloc: list[dict[int, int]] = []
    for k, edges in enumerate(group_edges):
        per: dict[int, int] = {}
        for eid, m in edges:
            sent = g.cap[eid ^ 1]  # flow = reverse residual
            if sent > 0:
                per[m] = sent
        alloc.append(per)
    return Assignment(alloc=alloc, phi=int(phi))
