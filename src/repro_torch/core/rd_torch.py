"""Replica-Deletion on torch tensors: the port of ``repro/core/rd_jax.py``.

The class-compressed RD (:mod:`repro_torch.core.rd`) recast as a
fixed-shape program over device tensors.  A *slot* is one equivalence
class ``(group, surviving servers)``:

- ``holders``: ``(C, A)`` int32 — the class's server set, sorted
  ascending, padded with ``M`` (sorts after every real id); a slot's
  holder row is static while it holds members (deletions spin members
  into another slot);
- ``size``/``cnt``/``grp``: ``(C,)`` member count (0 = free: drained or
  never used), replica count, group id;
- ``hash``: ``(C,)`` int64 hash of the class ``(group, servers)``;
- ``load``/``multi``/``busy_est``: ``(M,)`` delta-updated server state.

One *strip* of server ``m`` sorts the candidate slots (active, on ``m``,
multi-copy) by the key ``(-count, alt, holder row, group, slot)``, walks
the prefix of their member counts against the quota
``((load-1) mod μ)+1``, and re-homes the deleted members with scatters.
The sort and the walk are the strip kernel's
(:func:`repro_torch.kernels.rd.rd_strip_takes`: the CUDA kernel on the
card, its plain version for CPU tensors).  All state but the class
hashes is int32, as in the reference, and every result equals the host
RD's.  Groups wider than 32 servers are refused: their strip key would
not fit the kernel's 24 key rows.

Where the reference differs from a literal transcription:

- **A class holds one live slot; drained slots are reused.**  The
  reference allocates every spin-off from a bump counter and caches it
  per (slot, stripped server) in a ``dest`` matrix, so a slot is never
  freed and one class may hold several; with its capacity rule
  ``32·K·A + 256`` it overflows on many jobs of a 4096-server bursty
  trace (a job of 1,875 tasks needs 6,106 slots) and re-runs them on
  the host.  Here, as in the host RD's class map, members leaving a slot
  join the live slot of their new class ``(group, servers ∖ {m})`` when
  it has one, else the first free slot (``size == 0``: drained or never
  used).  The class's slot is found by a binary search over the live
  slots' class hashes and confirmed by its holder row and group.  Live
  slots are then bounded by live classes, and :func:`rd_slot_capacity`
  keeps the reference's rule, capped at the kernel's ceiling; an
  overflow re-runs the problem on the host, and is counted.  Where the
  slot index differs from the reference's it never reaches the result:
  the assignment sums members per ``(group, server)``, and slots of one
  class would be exchangeable (a hash collision only leaves a class in
  two slots, whose keys differ in the slot index alone, so a strip walks
  them one after the other);
- ``lax.while_loop`` becomes a Python loop over device tensors that
  reads its exit flags on the host only every few iterations
  (:func:`_drive`); an iteration past the exit is a no-op, since its
  strip runs with quota 0 (no take, so no move, and ``busy_est[m]``
  recomputes to its own value) and nothing else it writes is read after
  the exit;
- ``lax.cond`` around the strip becomes that same quota gate;
- ``mode="drop"`` scatters write into one spare row (slot ``C``) or lane
  (server ``M``) that every buffer carries and no result reads;
- the alt key, which the reference caches per slot as the triple
  ``(m1, b1, b2)`` of ``_alt_triple``, is recomputed per strip as the
  least initial busy time over the row's other holders — the same value
  on every row, since holder ids are unique within a row;
- the packed holder words (two 15-bit ids per int32, ``_pack_setkey``)
  are packed from the holder rows per strip instead of being stored.

The chain admits a same-slot burst one job at a time, committing eq. 2
on the device between jobs; each job has its own slot capacity.  Each
adapter brings its results to the host once; an overflow re-runs the
problem (or the whole burst) on the host RD and counts one
``host_reruns`` in :data:`COUNTS`.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .. import backend
from ..kernels import rd as rdk
from .instance import Assignment, AssignmentProblem
from .rd import RD_DEVICE_MAX_M, host_commit_walk, replica_deletion
from .reorder import commit_busy

__all__ = [
    "COUNTS",
    "rd_slot_capacity",
    "replica_deletion_torch",
    "replica_deletion_torch_chain",
    "reset_counts",
]

I32 = torch.int32
_BIG = rdk.BIG  # non-candidate and sole-copy sentinel (the reference's _BIG)
_I32_MIN = -(2**31)
# sort keys pack two 15-bit server ids per int32 word: lexicographic on the
# packed words == lexicographic on the sorted holder rows.  Requires
# M <= RD_DEVICE_MAX_M.
_PACK_BITS = 15
# class hash = Σ of a random 57-bit word per server (0 for the pad id)
# plus a 57-bit group term: at most 33 terms, so int64 sums never wrap
# (rows are limited to 32 ids, see _MAX_ROW_IDS)
_HASH_MASK = (1 << 57) - 1
_HASH_SEED = 0x5D1F
_GROUP_MULT = 0x6A09E667  # odd, < 2^31: grp · mult stays below 2^62
_HASH_FREE = (1 << 63) - 1  # the sort key of slots without members
# iterations run between two host reads of a loop's exit flags: 1, 2, 4,
# ... up to this many (iterations past the exit are no-ops)
_CHECK_EVERY_MAX = 16
# the widest holder row whose strip key fits the kernel's key rows: rows
# pad to a power of two A, and a strip key is 3 + A/2 rows
_MAX_ROW_IDS = 32

COUNTS = {"host_reruns": 0}
# (slot capacity, most live slots) of each problem the device solved
SLOT_PEAKS: list[tuple[int, int]] = []


def reset_counts() -> None:
    for key in COUNTS:
        COUNTS[key] = 0
    SLOT_PEAKS.clear()


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _ceil_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return -(-a // b)


def rd_slot_capacity(problem: AssignmentProblem) -> int:
    """Slot capacity ``C`` for one instance: a power of two in
    ``[128, RD_MAX_C]``.

    The reference's rule, capped at the strip kernel's lane ceiling: the
    smaller of the hard bound ``K + Σ_k size_k·(|S_k|-1)`` (each new
    class comes from a move, which deletes a replica) and the heuristic
    ``32·K·A + 256``.  Here it bounds the *live* slots, one per live
    class; on ``chip_smoke.py``'s 4096-server bursty trace no job fills
    more than 83 % of it (``tools/rd_slot_census.py``).  A job that
    still runs out re-runs on the host.
    """
    k = len(problem.groups)
    a_max = max((len(g.servers) for g in problem.groups), default=1)
    hard = k + sum(g.size * (len(g.servers) - 1) for g in problem.groups) + 1
    heuristic = 32 * k * a_max + 256
    return max(rdk.MIN_LANES, min(rdk.RD_MAX_C, _next_pow2(min(hard, heuristic))))


@functools.lru_cache(maxsize=4)
def _server_hash_words(m_servers: int) -> np.ndarray:
    """(M+1,) int64 random 57-bit words, one per server, 0 for the pad."""
    words = np.random.default_rng(_HASH_SEED).integers(
        1, _HASH_MASK, m_servers + 1, dtype=np.int64
    )
    words[m_servers] = 0
    return words


def _a_pad(problems: list[AssignmentProblem]) -> int:
    """Padded holder-row width: a power of two ≥ 2 (packs in pairs)."""
    a_max = max((len(g.servers) for p in problems for g in p.groups), default=1)
    return _next_pow2(max(2, a_max))


def _pack_setkey(holders: torch.Tensor) -> torch.Tensor:
    """(C, A) holder rows → (C, A/2) packed sort-key words."""
    return (holders[:, 0::2] << _PACK_BITS) | holders[:, 1::2]


@dataclasses.dataclass
class _RDDev:
    """The dense class-compressed state.  Slot buffers carry one spare
    row (index ``C``) and server buffers one spare lane (index ``M``):
    the targets of the reference's dropped scatters.  Every buffer but
    ``grp`` is only ever updated in place, so the views of its live rows
    (``holders_c`` ... ``multi_m``) stay valid."""

    holders: torch.Tensor  # (C+1, A) i32, sorted asc, pad = M
    size: torch.Tensor  # (C+1,) i32 members (0 = free)
    cnt: torch.Tensor  # (C+1,) i32 replica count
    grp: torch.Tensor  # (C+1,) i32 group id
    hash: torch.Tensor  # (C+1,) i64 class hash of (grp, holders)
    load: torch.Tensor  # (M+1,) i32
    multi: torch.Tensor  # (M+1,) i32 multi-copy population per server
    busy_est: torch.Tensor  # (M,) i32  b_m + ceil(load_m/mu_m)
    # (1,) i32: the fewest free slots left after a strip took its new
    # ones; C minus it is the most live slots, and < 0 is an overflow
    headroom: torch.Tensor

    def __post_init__(self) -> None:
        self.holders_c = self.holders[:-1]
        self.size_c = self.size[:-1]
        self.cnt_c = self.cnt[:-1]
        self.hash_c = self.hash[:-1]
        self.load_m = self.load[:-1]
        self.multi_m = self.multi[:-1]


@dataclasses.dataclass(frozen=True)
class _Ctx:
    """Per-instance constants of one RD run."""

    busy0: torch.Tensor  # (M,) i32 initial busy times
    busy_ext: torch.Tensor  # (M+1,) i32, busy0 then _BIG for the pad id
    mu: torch.Tensor  # (M,) i32
    words: torch.Tensor  # (M+1,) i64 per-server class-hash words
    rows: torch.Tensor  # (C,) i64 slot indices
    pad_col: torch.Tensor  # (C, 1) i32 filled with M

    @property
    def c_slots(self) -> int:
        return self.rows.shape[0]

    @property
    def m_servers(self) -> int:
        return self.busy0.shape[0]


def _strip(
    st: _RDDev,
    ctx: _Ctx,
    m: torch.Tensor,
    gate: torch.Tensor,
    hl: torch.Tensor,
    active_cnt: torch.Tensor,
) -> torch.Tensor:
    """Delete up to ``((load-1) mod μ)+1`` multi-copy replicas from
    server ``m`` (a ``(1,)`` index) when ``gate``; updates ``st`` and
    returns the number removed.  ``hl`` is the live holder rows as int64
    and ``active_cnt`` the replica count of slots with members (0 on free
    slots).

    The reference's sequential max-key pops collapse into one sort +
    prefix-sum (keys are static within a strip — deleted members leave
    ``m``); every delta update is a scatter.
    """
    c_slots, m_servers = ctx.c_slots, ctx.m_servers
    holders, size, cnt = st.holders_c, st.size_c, st.cnt_c
    load_m = st.load.index_select(0, m)
    mu_m = ctx.mu.index_select(0, m)
    quota = torch.where(gate, (load_m - 1) % mu_m + 1, 0)

    is_m = holders == m  # (C, A)
    cand = is_m.any(1) & (active_cnt >= 2)
    # alt: least initial busy time over the row's other holders
    altv = torch.where(is_m, _BIG, ctx.busy_ext[hl]).amin(1)
    neg_key = torch.where(cand, -cnt, _BIG)

    # --- bucket walk: sort by the strip key, prefix-sum sizes vs quota ---
    keys = torch.cat(
        [neg_key[None], altv[None], _pack_setkey(holders).T, st.grp[None, :c_slots]]
    )
    take_sorted, order = rdk.rd_strip_takes(keys, size, quota)
    # order is a permutation, so the scatter writes every lane
    take = torch.empty_like(take_sorted).scatter_(0, order.long(), take_sorted)
    removed = take.sum(dtype=I32).reshape(1)

    # --- re-home the deleted members -------------------------------------
    # spun holder row: drop the (unique) entry equal to m, shift left
    shifted = torch.cat([holders[:, 1:], ctx.pad_col], 1)
    spun = torch.where(is_m.cumsum(1) > 0, shifted, holders)
    spun_hash = st.hash_c - ctx.words.index_select(0, m)
    # a mover's members join their new class's live slot ("home") when it
    # has one: the first live slot with the same hash, confirmed by its
    # group and holder row.  A search past the last key checks the last
    # slot, which the confirmation then refuses.
    live = st.size > 0
    by_hash, slot_of = torch.where(live[:c_slots], st.hash_c, _HASH_FREE).sort()
    at = torch.searchsorted(by_hash, spun_hash).clamp_(max=c_slots - 1)
    home = slot_of.index_select(0, at)
    grp_c = st.grp[:c_slots]
    mv = take > 0
    merge = (
        mv
        & live.index_select(0, home)
        & (st.grp.index_select(0, home) == grp_c)
        & (st.holders.index_select(0, home) == spun).all(1)
    )
    # else the i-th new class (in slot order) takes the i-th free slot; one
    # past the last free slot lands in the spare row and drives the
    # headroom negative (the result is discarded then)
    new = mv & ~merge
    free = size == 0
    free_rank = torch.cumsum(free, 0, dtype=I32)
    new_rank = torch.cumsum(new, 0, dtype=I32)
    st.headroom = torch.minimum(st.headroom, free_rank[-1:] - new_rank[-1:])
    free_ids = torch.full((c_slots + 1,), c_slots, dtype=torch.long, device=size.device)
    free_ids.index_copy_(0, torch.where(free, free_rank - 1, c_slots).long(), ctx.rows)
    tgt = torch.where(
        new,
        free_ids.index_select(0, (new_rank - 1).clamp(min=0)),
        torch.where(merge, home, c_slots),
    )
    c2 = mv & (cnt == 2)

    # a home already holds the spun row, group and count: rewriting them
    # is a no-op
    st.holders.index_copy_(0, tgt, spun)
    st.hash.index_copy_(0, tgt, spun_hash)
    st.grp = st.grp.index_copy(0, tgt, grp_c)
    st.cnt.index_copy_(0, tgt, cnt - 1)
    size.sub_(take)
    st.size.index_add_(0, tgt, take)

    # --- delta-update the server vectors -------------------------------
    neg_removed = -removed
    st.multi.index_add_(0, m, neg_removed)
    # members of a count-2 class became sole-copy on their last holder
    st.multi.index_add_(0, torch.where(c2, spun[:, 0], m_servers), -take)
    st.load.index_add_(0, m, neg_removed)
    busy_m = ctx.busy0.index_select(0, m) + _ceil_div(load_m + neg_removed, mu_m)
    st.busy_est.index_copy_(0, m, busy_m)
    return removed


def _peek_vec(
    ctx: _Ctx, hl: torch.Tensor, active_cnt: torch.Tensor
) -> torch.Tensor:
    """Max replica count among active classes, per server (scatter-max)."""
    m_servers = ctx.m_servers
    vals = active_cnt[:, None].expand_as(hl).reshape(-1)
    peek = torch.zeros(m_servers + 1, dtype=I32, device=vals.device)
    peek.scatter_reduce_(0, hl.reshape(-1), vals, "amax")
    return peek[:m_servers]


def _refine_max(
    mask: torch.Tensor, key: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Narrow ``mask`` to the entries attaining ``max(key over mask)``."""
    best = torch.where(mask, key, _I32_MIN).amax()
    return mask & (key == best), best


def _drive(step, stop) -> None:
    """Run ``step`` until ``stop()`` holds, reading the flag on the host
    after 1, 2, 4, ... up to :data:`_CHECK_EVERY_MAX` iterations."""
    every = 1
    while not bool(stop()):
        for _ in range(every):
            step()
        every = min(2 * every, _CHECK_EVERY_MAX)


def _rd_core(
    busy0: torch.Tensor,
    mu: torch.Tensor,
    holders0: torch.Tensor,
    size0: torch.Tensor,
    cnt0: torch.Tensor,
    grp0: torch.Tensor,
) -> _RDDev:
    """Run the whole RD (deletion + dedup) for one instance on the device.

    ``holders0`` etc. carry ``C + 1`` rows (the last one spare, padded
    with ``M`` and empty); they are updated in place.
    """
    c_slots = holders0.shape[0] - 1
    m_servers = busy0.shape[0]
    dev = busy0.device
    busy0 = busy0.to(I32)
    mu = mu.to(I32)
    ctx = _Ctx(
        busy0=busy0,
        busy_ext=torch.cat([busy0, torch.full((1,), _BIG, dtype=I32, device=dev)]),
        mu=mu,
        words=torch.from_numpy(_server_hash_words(m_servers)).to(dev),
        rows=torch.arange(c_slots, device=dev),
        pad_col=torch.full((c_slots, 1), m_servers, dtype=I32, device=dev),
    )
    flat = holders0.long().reshape(-1)
    hash0 = ctx.words.index_select(0, flat).view(holders0.shape).sum(1)
    hash0 += (grp0.long() * _GROUP_MULT) & _HASH_MASK
    bsize = size0[:, None].expand_as(holders0).reshape(-1)
    bmulti = torch.where(cnt0 >= 2, size0, 0)[:, None].expand_as(holders0).reshape(-1)
    zeros = torch.zeros(m_servers + 1, dtype=I32, device=dev)
    load = zeros.index_add(0, flat, bsize)
    st = _RDDev(
        holders=holders0,
        size=size0,
        cnt=cnt0,
        grp=grp0,
        hash=hash0,
        load=load,
        multi=zeros.index_add(0, flat, bmulti),
        busy_est=busy0 + _ceil_div(load[:m_servers], mu),
        headroom=(size0[:c_slots] == 0).sum(dtype=I32).reshape(1),
    )
    load, multi, busy_est = st.load_m, st.multi_m, st.busy_est

    # ---- deletion phase --------------------------------------------------
    # One iteration = one strip, with the level sweep folded in: when the
    # previous sweep's target set is exhausted, the same iteration opens a
    # new sweep (recomputes the max busy level + its servers and applies
    # the sole-copy exit check) before selecting a target.  Target
    # selection is a fresh argmax of (peek count, busy0, -id) over the
    # still-valid sweep targets — what the host's lazy re-ranking heap
    # realizes.  ``at_best`` (servers holding replicas at the sweep's
    # level) and ``sole`` (servers without multi-copy tasks) carry over
    # from the end of one iteration to the start of the next.
    held = load > 0
    carry = {
        "targets0": torch.zeros(m_servers, dtype=torch.bool, device=dev),
        "best": torch.full((1,), -2, dtype=I32, device=dev),
        "at_best": held & (busy_est == -2),
        "sole": multi == 0,
        "done": torch.zeros(1, dtype=torch.bool, device=dev),
    }

    def del_step() -> None:
        valid = carry["targets0"] & carry["at_best"]
        new_sweep = ~valid.any()
        held = load > 0
        nbest = torch.where(held, busy_est, -1).amax()
        ntargets = held & (busy_est == nbest)
        best = torch.where(new_sweep, nbest, carry["best"])
        carry["targets0"] = torch.where(new_sweep, ntargets, carry["targets0"])
        valid = torch.where(new_sweep, ntargets, valid)
        # sweep-entry exit: a target holding only sole-copy tasks means
        # the max busy level cannot drop any further
        done_now = new_sweep & ((nbest < 0) | (ntargets & carry["sole"]).any())
        active_cnt = torch.where(st.size_c > 0, st.cnt_c, 0)
        hl = st.holders_c.long()
        mask, p = _refine_max(valid, _peek_vec(ctx, hl, active_cnt))
        # the argmax of busy0 over the mask is the reference's second
        # refinement plus its first-True pick (busy0 >= 0 > the filler)
        m = torch.where(mask, busy0, _I32_MIN).argmax().reshape(1)
        stop = carry["done"] | done_now | (p <= 1)
        do_strip = ~stop
        removed = _strip(st, ctx, m, do_strip, hl, active_cnt)
        # a strip that ran out of quota drained m's multi-copy classes;
        # any still-max server with no multi-copy tasks ends the phase
        carry["best"] = best
        carry["at_best"] = (load > 0) & (busy_est == best)
        carry["sole"] = multi == 0
        tail = (removed == 0) | (carry["at_best"] & carry["sole"]).any()
        carry["done"] = stop | (do_strip & tail)

    _drive(del_step, lambda: carry["done"] | (st.headroom < 0))

    # ---- final dedup phase ----------------------------------------------
    # One strip per iteration from the busiest multi-copy holder,
    # (busy_est, busy0, id) descending — the reference's lexsort pick.
    def dd_step() -> None:
        mask = multi > 0
        go = mask.any().reshape(1)
        mask, _ = _refine_max(mask, busy_est)
        # last argmax of busy0 over the mask: ties go to the largest id
        pick = torch.where(mask, busy0, _I32_MIN).flip(0).argmax()
        active_cnt = torch.where(st.size_c > 0, st.cnt_c, 0)
        m = (m_servers - 1 - pick).reshape(1)
        _strip(st, ctx, m, go, st.holders_c.long(), active_cnt)

    _drive(dd_step, lambda: ~(multi > 0).any() | (st.headroom < 0))
    return st


def _result(st: _RDDev) -> torch.Tensor:
    """size, cnt, grp, primary server (C each) and the headroom, as one
    int32 vector for a single device→host transfer."""
    c = st.holders.shape[0] - 1
    return torch.cat(
        [st.size[:c], st.cnt[:c], st.grp[:c], st.holders[:c, 0], st.headroom]
    )


def _split(flat: np.ndarray) -> tuple[tuple[np.ndarray, ...], int]:
    """The inverse of :func:`_result`: (size, cnt, grp, srv), headroom."""
    c = (flat.shape[0] - 1) // 4
    return tuple(flat[i * c : (i + 1) * c] for i in range(4)), int(flat[-1])


# ---------------------------------------------------------------------------
# host adapters (numpy helpers copied from repro/core/rd_jax.py)


def _dense_instance(
    problem: AssignmentProblem, c_cap: int, a_pad: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Initial slot arrays: one slot per task group, padded to
    ``(C + 1, A)`` (the last row is the spare)."""
    m = problem.n_servers
    holders = np.full((c_cap + 1, a_pad), m, dtype=np.int32)
    size = np.zeros(c_cap + 1, dtype=np.int32)
    cnt = np.zeros(c_cap + 1, dtype=np.int32)
    grp = np.zeros(c_cap + 1, dtype=np.int32)
    for k, g in enumerate(problem.groups):
        holders[k, : len(g.servers)] = g.servers
        size[k] = g.size
        cnt[k] = len(g.servers)
        grp[k] = k
    return holders, size, cnt, grp


def _decode(
    problem: AssignmentProblem,
    size: np.ndarray,
    cnt: np.ndarray,
    grp: np.ndarray,
    srv: np.ndarray,
) -> Assignment:
    act = np.flatnonzero(size > 0)
    if not (cnt[act] == 1).all():  # pragma: no cover - device invariant
        raise AssertionError("dedup must leave exactly one replica")
    dense = np.zeros((len(problem.groups), problem.n_servers), dtype=np.int64)
    np.add.at(dense, (grp[act], srv[act]), size[act])
    alloc: list[dict[int, int]] = [
        {int(m): int(row[m]) for m in np.flatnonzero(row)} for row in dense
    ]
    if int(size[act].sum()) != problem.n_tasks:  # pragma: no cover
        raise AssertionError("class bookkeeping lost tasks")
    result = Assignment(alloc=alloc, phi=0)
    result.phi = result.realized_phi(problem)
    result.validate(problem)
    return result


def _check_servers(m: int) -> None:
    if m > RD_DEVICE_MAX_M:
        raise ValueError(
            f"device RD supports at most {RD_DEVICE_MAX_M} servers "
            f"(15-bit packed sort keys), got {m} — use the host rd"
        )


def _to_device(*arrays: np.ndarray) -> list[torch.Tensor]:
    """One host→device copy for all int32 arrays, returned as views."""
    flat = np.concatenate([np.asarray(a, dtype=np.int32).reshape(-1) for a in arrays])
    buf = torch.from_numpy(flat).to(backend.device())
    out, at = [], 0
    for a in arrays:
        n = int(np.prod(np.shape(a), dtype=np.int64))
        out.append(buf[at : at + n].view(np.shape(a)))
        at += n
    return out


def _instance_on_device(problem: AssignmentProblem) -> list[torch.Tensor]:
    """(mu, holders, size, cnt, grp) on the device."""
    a_pad = _a_pad([problem])
    if a_pad > _MAX_ROW_IDS:
        raise ValueError(
            f"device RD supports groups of at most {_MAX_ROW_IDS} available "
            f"servers (the strip kernel's {rdk.RD_MAX_KEY_ROWS} key rows) — "
            "use the host rd"
        )
    c_cap = rd_slot_capacity(problem)
    return _to_device(problem.mu, *_dense_instance(problem, c_cap, a_pad))


def replica_deletion_torch(problem: AssignmentProblem) -> Assignment:
    """Host-facing RD with the strips on the device (registered as
    ``"rd_torch"``); the same assignment as the host
    :func:`repro_torch.core.rd.replica_deletion`.  A slot-capacity
    overflow (see :func:`rd_slot_capacity`) re-runs the problem on the
    host and counts one ``host_reruns``."""
    _check_servers(problem.n_servers)
    if problem.n_tasks == 0:
        result = Assignment(alloc=[], phi=0)
        result.phi = result.realized_phi(problem)
        return result
    (busy0,) = _to_device(problem.busy)
    st = _rd_core(busy0, *_instance_on_device(problem))
    parts, headroom = _split(_result(st).cpu().numpy())
    if headroom < 0:
        COUNTS["host_reruns"] += 1
        return replica_deletion(problem)
    c = parts[0].shape[0]
    SLOT_PEAKS.append((c, c - headroom))
    return _decode(problem, *parts)


def replica_deletion_torch_chain(
    problems: list[AssignmentProblem],
) -> list[Assignment]:
    """Admit a same-slot RD burst in one chained device pass.

    Every problem must share one cluster and carry the *same* pre-burst
    busy vector (eq. 2 is committed between jobs on the device), as
    :meth:`repro_torch.runtime.policies.Policy.assign_batch` hands them
    over.  The assignments are identical to sequential
    :func:`replica_deletion_torch` calls with busy times re-read after
    each enqueue; a job overflowing its slot capacity re-runs the whole
    burst with :func:`repro_torch.core.rd.host_commit_walk`.
    """
    if not problems:
        return []
    m = problems[0].n_servers
    if any(p.n_servers != m for p in problems):
        raise ValueError("chained RD requires a single cluster size")
    _check_servers(m)
    base = problems[0].busy
    if any(
        p.busy is not base and not np.array_equal(p.busy, base)
        for p in problems[1:]
    ):
        raise ValueError(
            "chained RD requires every problem to carry the same pre-burst "
            "busy vector (eq. 2 is committed inside the chain)"
        )
    (busy,) = _to_device(base)
    outs = []
    for p in problems:
        mu, *slots = _instance_on_device(p)
        st = _rd_core(busy, mu, *slots)
        if int(st.headroom) < 0:
            # an overflowed job corrupts every later job's busy carry:
            # walk the burst on the host (identical assignments)
            COUNTS["host_reruns"] += 1
            return host_commit_walk(problems)
        loads = torch.zeros(m + 1, dtype=I32, device=busy.device)
        loads.index_add_(0, st.holders_c[:, 0], st.size_c)
        loads = loads[:m]
        busy = busy + torch.where(loads > 0, _ceil_div(loads, mu), 0)  # eq. 2
        outs.append(_result(st))
    flat = torch.cat(outs).cpu().numpy()
    busy_h = np.asarray(base)
    out: list[Assignment] = []
    at = 0
    for i, (p, o) in enumerate(zip(problems, outs)):
        parts, headroom = _split(flat[at : at + o.shape[0]])
        at += o.shape[0]
        c = parts[0].shape[0]
        SLOT_PEAKS.append((c, c - headroom))
        prob_i = p if i == 0 else dataclasses.replace(p, busy=busy_h)
        a = _decode(prob_i, *parts)
        out.append(a)
        busy_h = commit_busy(busy_h, a, prob_i.mu, m)
    return out
