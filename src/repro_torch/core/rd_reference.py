"""Reference Replica-Deletion — the heap/set oracle for the vectorized RD.

This is the original per-task-set / lazy-heap implementation of the
paper's RD (Sec. III-C), kept as an executable specification: the
class-compressed :func:`repro_torch.core.rd.replica_deletion` (and the
device RD, ``rd_torch``) must produce the
*same assignment* on every instance, which the test suite checks on
seeded problems.  To make that equivalence exact, the random tie-breaks
of the original implementation are replaced by a fixed order — tasks by
(surviving-server set, group, task index), servers by id — so the
selection sequence is a deterministic function of the state rather than
of heap-internal event order or generator state.

Tie-breaking (paper Fig. 9): target servers break ties by largest
*initial* busy time; equal-count tasks break by the cheapest surviving
alternative, then the fixed order above.  The port's copy of
``repro/core/rd_reference.py``.  See :mod:`repro_torch.core.rd` for
the production implementation and the complexity discussion.

``seed`` is retained for API compatibility; the run is deterministic
and ignores it.
"""

from __future__ import annotations

import heapq

import numpy as np

from .instance import Assignment, AssignmentProblem

__all__ = ["replica_deletion_reference"]

_BIG = 1 << 30

# task sort key: (-count, alt, surviving servers, group, task id)
_Key = tuple[int, int, tuple[int, ...], int, int]


class _RDState:
    def __init__(self, problem: AssignmentProblem):
        self.busy0 = problem.busy.astype(np.int64)
        self.mu = problem.mu.astype(np.int64)
        n_servers = problem.n_servers
        self.task_group: list[int] = []
        for k, g in enumerate(problem.groups):
            self.task_group.extend([k] * g.size)
        n = len(self.task_group)
        self.count = np.zeros(n, dtype=np.int64)
        self.present: list[set[int]] = [set() for _ in range(n)]
        self.on_server: list[set[int]] = [set() for _ in range(n_servers)]
        t = 0
        for g in problem.groups:
            for _ in range(g.size):
                self.count[t] = len(g.servers)
                self.present[t] = set(g.servers)
                for m in g.servers:
                    self.on_server[m].add(t)
                t += 1
        self.load = np.array([len(s) for s in self.on_server], dtype=np.int64)
        self.busy_est = self.busy0 + -(-self.load // self.mu)  # incremental
        self.multi_on = np.zeros(n_servers, dtype=np.int64)
        for m in range(n_servers):
            self.multi_on[m] = sum(1 for t in self.on_server[m] if self.count[t] > 1)
        self._alt_best: list[tuple[int, int, int]] = [(-1, _BIG, _BIG)] * n
        for t in range(n):
            self._refresh_alt(t)
        self.task_heaps: list[list[tuple[_Key, int]]] = [
            [] for _ in range(n_servers)
        ]
        for m in range(n_servers):
            for t in self.on_server[m]:
                heapq.heappush(self.task_heaps[m], (self._key(t, m), t))
        # peek_max_count cache; a deletion of task t only invalidates t's
        # holders, so most target scans are dict lookups
        self.peek_cache: dict[int, int] = {}

    def _refresh_alt(self, t: int) -> None:
        """Cache the two cheapest holders of t by initial busy time, so
        ``_alt`` is O(1) (recomputed only when t loses a holder)."""
        m1 = -1
        b1 = b2 = _BIG
        for m in self.present[t]:
            b = int(self.busy0[m])
            if b < b1:
                b2 = b1
                m1, b1 = m, b
            elif b < b2:
                b2 = b
        self._alt_best[t] = (m1, b1, b2)

    def _alt(self, t: int, m: int) -> int:
        """Initial busy time of the cheapest *other* holder of task t."""
        m1, b1, b2 = self._alt_best[t]
        return b2 if m == m1 else b1

    def _key(self, t: int, m: int) -> _Key:
        return (
            -int(self.count[t]),
            self._alt(t, m),
            tuple(sorted(self.present[t])),
            self.task_group[t],
            t,
        )

    def busy_vec(self) -> np.ndarray:
        """b_m + ⌈load_m/μ_m⌉ for all servers (maintained incrementally:
        deletions only change the stripped server's own load)."""
        return self.busy_est

    def _settle(self, m: int, *, strict: bool) -> None:
        """Drop/refresh stale heap head for server m.

        Counts only decrease and ``alt`` only increases over time, so stale
        entries are always *optimistic* (sort earlier than deserved): fixing
        them by re-pushing a corrected key is safe.  ``strict=False`` only
        validates the count — enough for :meth:`peek_max_count` and ~3×
        cheaper, since ``alt`` never affects the max count.
        """
        h = self.task_heaps[m]
        while h:
            key, t = h[0]
            if m not in self.present[t]:
                heapq.heappop(h)
                continue
            c = int(self.count[t])
            if -key[0] != c:
                heapq.heappop(h)
                heapq.heappush(h, (self._key(t, m), t))
                continue
            if strict and key[1] != self._alt(t, m):
                heapq.heappop(h)
                heapq.heappush(h, (self._key(t, m), t))
                continue
            return

    def peek_max_count(self, m: int) -> int:
        cached = self.peek_cache.get(m)
        if cached is not None:
            return cached
        self._settle(m, strict=False)
        h = self.task_heaps[m]
        val = -h[0][0][0] if h else 0
        self.peek_cache[m] = val
        return val

    def pop_max_task(self, m: int) -> int | None:
        self._settle(m, strict=True)
        h = self.task_heaps[m]
        if not h:
            return None
        return heapq.heappop(h)[1]

    def delete_replica(self, t: int, m: int) -> None:
        """Heap entries for t's other holders go stale; peek/pop fix them
        lazily (cheaper than eagerly re-pushing ~count entries per delete)."""
        was_multi = self.count[t] > 1
        self.present[t].discard(m)
        self.on_server[m].discard(t)
        self.load[m] -= 1
        self.count[t] -= 1
        self._refresh_alt(t)
        if was_multi:
            self.multi_on[m] -= 1
        self.peek_cache.pop(m, None)
        for m2 in self.present[t]:
            self.peek_cache.pop(m2, None)
        if self.count[t] == 1:
            (m_last,) = self.present[t]
            self.multi_on[m_last] -= 1

    def strip(self, m_star: int) -> int:
        """Delete enough multi-copy replicas from ``m_star`` to drop one
        busy slot (``((load-1) mod μ)+1`` — the paper's "up to μ"); returns
        number removed."""
        mu = int(self.mu[m_star])
        quota = ((int(self.load[m_star]) - 1) % mu) + 1
        removed = 0
        while removed < quota and self.peek_max_count(m_star) >= 2:
            t = self.pop_max_task(m_star)
            if t is None:
                break
            self.delete_replica(t, m_star)
            removed += 1
        if removed:
            self.busy_est[m_star] = self.busy0[m_star] + -(
                -int(self.load[m_star]) // int(self.mu[m_star])
            )
        return removed


def replica_deletion_reference(
    problem: AssignmentProblem, seed: int = 0
) -> Assignment:
    del seed  # deterministic; retained for API compatibility
    st = _RDState(problem)

    # ---- deletion phase --------------------------------------------------
    # Per level sweep: all servers tied at the max busy level are stripped
    # one busy-slot each, in descending (max replica count, initial busy)
    # order; the order heap is validated lazily at pop time, so counts are
    # always fresh when a target is actually stripped.
    done = False
    while not done:
        held = st.load > 0
        best = int(st.busy_est[held].max())
        tmask = held & (st.busy_est == best)
        # exit: some target holds only sole-copy tasks (multi_on == 0) →
        # the max estimated busy time cannot be reduced any further
        if bool((tmask & (st.multi_on == 0)).any()):
            break
        targets = np.flatnonzero(tmask)
        heap = [
            (-st.peek_max_count(int(m)), -int(st.busy0[m]), int(m))
            for m in targets
        ]
        heapq.heapify(heap)
        while heap:
            negc, negb0, m = heapq.heappop(heap)
            if st.load[m] <= 0 or int(st.busy_est[m]) != best:
                continue  # already stripped below this level
            c = st.peek_max_count(m)
            if -negc != c:  # count moved since push; re-rank
                heapq.heappush(heap, (-c, negb0, m))
                continue
            if c <= 1 or st.strip(m) == 0:
                done = True
                break
            # deletions may have drained another target's multi-copy tasks
            tmask = (st.load > 0) & (st.busy_est == best)
            if bool((tmask & (st.multi_on == 0)).any()):
                done = True
                break

    # ---- final dedup phase -------------------------------------------------
    # Each remaining multi-copy task keeps exactly one replica; replicas are
    # stripped from the busiest holders first to keep loads balanced.
    while True:
        mask = st.multi_on > 0
        if not mask.any():
            break
        busy = st.busy_vec()
        cand = np.flatnonzero(mask)
        order = np.lexsort((st.busy0[cand], busy[cand]))
        m_star = int(cand[order[-1]])  # stable: ties fall to largest id
        removed = st.strip(m_star)
        assert removed > 0, "masked server must hold a multi-copy task"

    # ---- build assignment --------------------------------------------------
    alloc: list[dict[int, int]] = [dict() for _ in problem.groups]
    for t in range(len(st.count)):
        assert st.count[t] == 1, "dedup must leave exactly one replica"
        (m,) = st.present[t]
        k = st.task_group[t]
        alloc[k][m] = alloc[k].get(m, 0) + 1
    result = Assignment(alloc=alloc, phi=0)
    result.phi = result.realized_phi(problem)
    result.validate(problem)
    return result
