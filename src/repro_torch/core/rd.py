"""Replica-Deletion task assignment (paper Sec. III-C), on the host.

A copy of the host parts of ``repro/core/rd.py``: the class-compressed
RD (:func:`replica_deletion`) and the sequential burst walk
(:func:`host_commit_walk`).  In the port they are the oracle that the
device RD (:mod:`repro_torch.core.rd_torch`, registered as
``rd_torch``) is held against, and the path its adapters re-run a
problem on when the device slot capacity overflows.  Registered as the
algorithm ``rd``.  The reference's backend dispatch
(``resolve_rd_backend``, ``replica_deletion_auto``,
``replica_deletion_batch``) is not copied: the port names its host and
device RD apart, ``rd`` and ``rd_torch``.

Every task starts replicated on *all* of its available servers.  RD then
iteratively picks the *target* server — largest estimated busy time
``b_m + ⌈load_m/μ_m⌉`` among servers holding replicas — and deletes just
enough replicas (``((load-1) mod μ)+1``, i.e. "up to μ_m^c") of the tasks
with the most copies to reduce the target's busy time by one slot.  Ties
across target servers break by the largest *initial* busy time (paper
Fig. 9); ties across equal-count tasks break by the cheapest surviving
alternative (the paper leaves this tie random — we use the freedom to
avoid stranding a task's last replica on an expensive server), then by a
fixed order (surviving-server set, then group, then task index), so the
whole algorithm is deterministic.  The deletion phase ends when some
target server holds only sole-copy tasks (its busy time can no longer
drop, so neither can the job's completion time).  A final phase dedups
the remaining multi-copy tasks off the busiest holders so each task runs
exactly once.

Implementation — class-compressed presence instead of per-task Python
sets and lazy heaps.  The key observation: rows of the ``(n_tasks, M)``
presence matrix repeat massively (all tasks of a group start with the
*same* available-server row, and a strip moves a whole batch of them
along the same row transition), and tasks sharing a row are exchangeable
under every selection rule above — so the state is *equivalence classes*
``(group, surviving servers) → member count`` rather than per-task rows:

- replica count and the cheapest-alternative tie-break are per-class
  scalars; server loads, busy estimates and multi-copy populations are
  delta-updated O(M) vectors, bucketed per server by replica count;
- deleting ``k`` replicas from a class is O(1): its member count drops
  by ``k`` and the ``servers∖{target}`` class's count rises by ``k``
  (destination classes are pointer-cached per stripped server);
- a strip of server ``m`` walks its count buckets descending, classes
  inside a bucket in ``(alt, servers, group)`` order — candidate keys
  are static within the strip (deleted members leave ``m``), so this is
  exactly the reference's sequential max-key pop order, and the walk
  order is cached until an activation invalidates it;
- target selection per sweep is the reference's lazy max-heap over ≤M
  entries; the dedup phase precomputes each busy level's static
  ``(busy0, id)`` strip order and only re-checks candidates for dropout
  (multi-copy population hitting zero) at their turn.

The selection sequence is a deterministic function of the state, so this
implementation is *assignment-identical* to the executable specification
in the reference's ``rd_reference``; the test suite checks that on seeded
instances.  Work per strip is O(active classes on the target) with tiny
constants instead of O(heap ops × log n) Python-object churn per task,
which cuts per-arrival overhead by ≥10× at policy-matrix scale.

``seed`` is retained for API compatibility; both implementations are
deterministic and ignore it.
"""

from __future__ import annotations

import dataclasses
import heapq

from .instance import Assignment, AssignmentProblem

__all__ = [
    "RD_DEVICE_MAX_M",
    "host_commit_walk",
    "replica_deletion",
]

_BIG = 1 << 30

# device RD's step kernel keeps one count per server id, the pad
# sentinel (the server count itself) included, in one block's shared
# memory (128 KB at this bound), so clusters wider than this stay on the
# host path — the same order of bound as the water-level kernel's
# MAX_LANES, and far past the paper's cluster sizes
RD_DEVICE_MAX_M = (1 << 15) - 1


def host_commit_walk(problems: list[AssignmentProblem]) -> list[Assignment]:
    """Sequential host-RD admission of a same-slot burst.

    Each job is assigned against the busy vector left by its
    predecessors via the eq. 2 commit — the same evolution
    :meth:`repro_torch.runtime.policies.Policy.assign_batch` produces for
    algorithms without a native batch path.  The device chain and its
    overflow fallback are both held to this walk's results.
    """
    from .reorder import commit_busy

    out: list[Assignment] = []
    busy = None
    for prob in problems:
        if busy is not None:
            prob = dataclasses.replace(prob, busy=busy)
        assignment = replica_deletion(prob)
        out.append(assignment)
        busy = commit_busy(prob.busy, assignment, prob.mu, prob.n_servers)
    return out


class _Cls:
    """One equivalence class of tasks: same group, same surviving servers.

    Members are anonymous (exchangeable), so the class is just a size.
    ``dest`` caches the ``servers∖{m}`` class per stripped server.
    """

    __slots__ = ("group", "servers", "count", "size", "b1", "m1", "b2", "dest")

    def __init__(self, group: int, servers: tuple[int, ...]):
        self.group = group
        self.servers = servers
        self.count = len(servers)
        self.size = 0
        self.dest: dict[int, _Cls] = {}
        self.m1 = -1  # alt tie-break computed lazily on first use
        self.b1 = -1
        self.b2 = -1

    def _compute_alt(self, busy0: list[int]) -> None:
        """Two cheapest holders by initial busy time, for the alt
        tie-break (deferred: many short-lived classes are never sorted)."""
        m1 = -1
        b1 = b2 = _BIG
        for m in self.servers:
            b = busy0[m]
            if b < b1:
                b2 = b1
                m1, b1 = m, b
            elif b < b2:
                b2 = b
        self.m1 = m1
        self.b1 = b1
        self.b2 = b2

    def alt(self, m: int) -> int:
        """Initial busy time of the cheapest *other* holder (``_BIG`` for
        sole-copy classes).  When the minimum is duplicated ``b2 == b1``,
        so any argmin representative gives the same value."""
        return self.b2 if m == self.m1 else self.b1


class _RDClasses:
    """Class-compressed RD state with delta-updated server vectors.

    Per-server scalar state lives in plain Python lists — every strip
    touches a handful of scalars, and list indexing beats numpy scalar
    indexing by ~5× at that granularity.
    """

    def __init__(self, problem: AssignmentProblem):
        self.busy0 = [int(b) for b in problem.busy]
        self.mu = [int(v) for v in problem.mu]
        m_servers = problem.n_servers
        self.m_servers = m_servers
        self.n = problem.n_tasks
        self.classes: dict[tuple[int, tuple[int, ...]], _Cls] = {}
        # buckets[m][count] -> active classes with that replica count on m
        # (count-indexed arrays, so walking counts descending is a plain
        # downward scan); order[m][count] caches the bucket's walk order
        # (keys are static per class, so only an activation invalidates it)
        self.max_count = max((len(g.servers) for g in problem.groups), default=1)
        self.buckets: list[list[set[_Cls] | None]] = [
            [None] * (self.max_count + 1) for _ in range(m_servers)
        ]
        self.order: list[list[list[_Cls] | None]] = [
            [None] * (self.max_count + 1) for _ in range(m_servers)
        ]
        self.load = [0] * m_servers
        self.multi_on = [0] * m_servers
        self.peek = [self.max_count] * m_servers  # lazy-decreasing pointer
        for k, g in enumerate(problem.groups):
            key = (k, g.servers)
            c = self.classes.get(key)
            if c is None:
                c = _Cls(k, g.servers)
                self.classes[key] = c
                self._activate(c)
            c.size += g.size
            for m in g.servers:
                self.load[m] += g.size
                if c.count > 1:
                    self.multi_on[m] += g.size
        self.busy_est = [
            b + -(-ld // mu) for b, ld, mu in zip(self.busy0, self.load, self.mu)
        ]
        # servers whose multi-copy population has hit zero *while holding
        # replicas*: the deletion phase's exit condition only ever needs
        # to look at these (zero-load servers can never trigger it)
        self.zero_multi: set[int] = {
            m
            for m in range(m_servers)
            if self.multi_on[m] == 0 and self.load[m] > 0
        }

    def _activate(self, c: _Cls) -> None:
        cnt = c.count
        buckets = self.buckets
        order = self.order
        for s in c.servers:
            members = buckets[s][cnt]
            if members is None:
                buckets[s][cnt] = {c}
            else:
                members.add(c)
            order[s][cnt] = None  # invalidate cached walk order

    def _deactivate(self, c: _Cls) -> None:
        # lazy: drained classes stay in cached walk orders and are skipped
        # by their size == 0 until the next rebuild
        cnt = c.count
        buckets = self.buckets
        for s in c.servers:
            buckets[s][cnt].discard(c)

    def peek_max_count(self, m: int) -> int:
        """Max replica count among active classes on ``m``.

        Monotone non-increasing over the run: an activation on ``m`` is
        always a ``count-1`` spin-off of a class that was on ``m`` at the
        same moment, so it can never raise the max — which makes the
        cached value a lazily-decreasing pointer (amortized O(1))."""
        buckets_m = self.buckets[m]
        p = self.peek[m]
        while p > 0 and not buckets_m[p]:
            p -= 1
        self.peek[m] = p
        return p

    def _move(self, c: _Cls, m: int, k: int) -> None:
        """Delete k replicas of class ``c`` from server ``m``, re-homing
        the members in the ``servers∖{m}`` class — O(1)."""
        size = c.size - k
        c.size = size
        buckets = self.buckets
        if size == 0:  # deactivate (inlined: this is the hot path)
            cnt = c.count
            for s in c.servers:
                buckets[s][cnt].discard(c)
        d = c.dest.get(m)
        if d is None:
            dest_servers = tuple(s for s in c.servers if s != m)
            dkey = (c.group, dest_servers)
            d = self.classes.get(dkey)
            if d is None:
                d = _Cls(c.group, dest_servers)
                self.classes[dkey] = d
            c.dest[m] = d
        if d.size == 0:  # fresh or previously drained: (re)activate
            cnt = d.count
            order = self.order
            for s in d.servers:
                members = buckets[s][cnt]
                if members is None:
                    buckets[s][cnt] = {d}
                else:
                    members.add(d)
                order[s][cnt] = None  # invalidate cached walk order
        d.size += k
        multi_on = self.multi_on
        multi_on[m] -= k  # every deleted member was multi-copy
        if multi_on[m] == 0:
            self.zero_multi.add(m)
        if c.count == 2:  # members became sole-copy on their last holder
            last = d.servers[0]
            multi_on[last] -= k
            if multi_on[last] == 0:
                self.zero_multi.add(last)

    def strip(self, m: int) -> int:
        """Delete up to ``((load-1) mod μ)+1`` multi-copy replicas from
        ``m`` — most copies first, ties by cheapest surviving alternative,
        then the fixed ``(servers, group)`` class order; returns the
        number removed.

        Candidate class keys are static within the strip (deleted members
        leave ``m``), so the sequential max-key pops of the reference
        collapse into one walk over count buckets (descending) and class
        order (ascending), taking prefixes.
        """
        quota = ((self.load[m] - 1) % self.mu[m]) + 1
        removed = 0
        buckets_m = self.buckets[m]
        order_m = self.order[m]
        move = self._move
        for cnt in range(self.peek_max_count(m), 1, -1):
            if removed >= quota:
                break
            bucket = buckets_m[cnt]
            if not bucket:
                continue
            walk = order_m[cnt]
            if walk is None:
                busy0 = self.busy0
                for c in bucket:
                    if c.b1 < 0:
                        c._compute_alt(busy0)
                walk = sorted(
                    bucket, key=lambda c: (c.alt(m), c.servers, c.group)
                )
                order_m[cnt] = walk
            dead = 0  # leading drained classes since the order was cached
            for c in walk:
                if c.size == 0:
                    dead += 1
                    continue
                if removed >= quota:
                    break
                k = quota - removed
                size = c.size
                if size < k:
                    k = size
                move(c, m, k)
                removed += k
                if c.size == 0:
                    dead += 1
                else:
                    break  # quota exhausted at a live class
            if dead:
                del walk[:dead]
        if removed:
            self.load[m] -= removed
            self.busy_est[m] = self.busy0[m] + -(-self.load[m] // self.mu[m])
        return removed


def replica_deletion(problem: AssignmentProblem, seed: int = 0) -> Assignment:
    del seed  # deterministic; retained for API compatibility
    st = _RDClasses(problem)
    if st.n == 0:
        result = Assignment(alloc=[], phi=0)
        result.phi = result.realized_phi(problem)
        return result
    m_all = range(st.m_servers)
    load, busy_est, busy0, multi_on = st.load, st.busy_est, st.busy0, st.multi_on

    # ---- deletion phase --------------------------------------------------
    # Per level sweep: all servers tied at the max busy level are stripped
    # one busy-slot each, in descending (max replica count, initial busy)
    # order with server id breaking exact ties; a lazy heap re-ranks a
    # target when its peek count moved, so selection always uses *current*
    # replica counts (stale entries are optimistic — counts only drop).
    done = False
    while not done:
        best = -1
        targets: list[int] = []
        for m in m_all:  # single pass: max level + its servers
            if load[m] > 0:
                b = busy_est[m]
                if b > best:
                    best = b
                    targets = [m]
                elif b == best:
                    targets.append(m)
        # exit: some target holds only sole-copy tasks (multi_on == 0) →
        # the max estimated busy time cannot be reduced any further
        if any(multi_on[m] == 0 for m in targets):
            break
        heap = [(-st.peek_max_count(m), -busy0[m], m) for m in targets]
        heapq.heapify(heap)
        while heap:
            negc, negb0, m = heapq.heappop(heap)
            if load[m] <= 0 or busy_est[m] != best:
                continue  # already stripped below this level
            c = st.peek_max_count(m)
            if -negc != c:  # count moved since push; re-rank
                heapq.heappush(heap, (-c, negb0, m))
                continue
            if c <= 1 or st.strip(m) == 0:
                done = True
                break
            # deletions may have drained another target's multi-copy tasks;
            # only servers whose multi population just hit zero can trigger
            if any(
                busy_est[z] == best and load[z] > 0 for z in st.zero_multi
            ):
                done = True
                break

    # ---- final dedup phase -----------------------------------------------
    # Each remaining multi-copy task keeps exactly one replica; replicas
    # are stripped from the busiest holders first to keep loads balanced.
    # Within one busy level every candidate's (busy_est, busy0, id) key is
    # static, so the level's strip order is precomputed and candidates are
    # only re-checked for dropout (multi_on → 0) at their turn.
    while True:
        best = -1
        level = []
        for m in m_all:  # single pass: max level among multi-copy holders
            if multi_on[m] > 0:
                b = busy_est[m]
                if b > best:
                    best = b
                    level = [m]
                elif b == best:
                    level.append(m)
        if best < 0:
            break
        level.sort(key=lambda m: (busy0[m], m), reverse=True)
        for m_star in level:
            if multi_on[m_star] <= 0 or busy_est[m_star] != best:
                continue
            removed = st.strip(m_star)
            assert removed > 0, "masked server must hold a multi-copy task"

    # ---- build assignment ------------------------------------------------
    alloc: list[dict[int, int]] = [dict() for _ in problem.groups]
    placed = 0
    for (k, servers), c in st.classes.items():
        if c.size == 0:
            continue
        assert c.count == 1, "dedup must leave exactly one replica"
        (m,) = servers
        alloc[k][m] = alloc[k].get(m, 0) + int(c.size)
        placed += int(c.size)
    assert placed == st.n, "class bookkeeping lost tasks"
    result = Assignment(alloc=alloc, phi=0)
    result.phi = result.realized_phi(problem)
    result.validate(problem)
    return result
