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
- ``hash``: ``(C,)`` int64 hash of the class ``(group, servers)``: the
  XOR of a random 57-bit word per server and a group term, so a row of
  any width hashes without overflow;
- ``load``/``multi``/``busy_est``: ``(M,)`` delta-updated server state.

The deletion and dedup loops run one iteration per call of
:func:`repro_torch.kernels.rd.rd_step` (one launch of the step kernel on
the card, its plain version for CPU tensors): the target pick, one
*strip* of the target server ``m`` — the candidate slots (active, on
``m``, multi-copy) sorted by ``(-count, alt, holder row, group, slot)``,
their member counts walked against the quota ``((load-1) mod μ)+1`` —
the re-homing of the deleted members and the delta updates.  All state
but the class hashes is int32, as in the reference, and every result
equals the host RD's, at any group width: holder rows wider than the
kernel's :data:`~repro_torch.kernels.rd.RD_MAX_ROW_IDS` take the plain
iteration on the card, by the wrapper's counted rule.

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
  used).  The class's slot is the lowest live slot with its hash,
  confirmed by its holder row and group.  Live slots are then bounded by
  live classes, and :func:`rd_slot_capacity` keeps the reference's rule,
  capped at the kernel's ceiling; an overflow re-runs the problem on the
  host, and is counted.  Where the slot index differs from the
  reference's it never reaches the result: the assignment sums members
  per ``(group, server)``, and slots of one class would be exchangeable
  (a hash collision only leaves a class in two slots, whose keys differ
  in the slot index alone, so a strip walks them one after the other);
- ``lax.while_loop`` becomes a Python loop of step calls that reads the
  loop's exit flag on the host only every few iterations
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
- the sort compares holder rows id by id where the reference packs them
  into 15-bit pairs (``_pack_setkey``): the same order.

The chain admits a same-slot burst one job at a time, committing eq. 2
on the device between jobs; each job has its own slot capacity.  Each
adapter brings its results to the host once; an overflow re-runs the
problem (or the whole burst) on the host RD and counts one
``host_reruns`` in :data:`COUNTS`.

Under an ambient :mod:`repro_torch.obs` session each adapter call is
profiled (``device.rd-device`` / ``rd-chain``) after its host read,
keyed by ``(kind, M, C, A[, B])``; ``host_fallback`` marks an overflow
re-run and holder rows past the step kernel's ceiling (the counted
``wide`` route).  The adapters declare the ``rd_torch.*`` geometry
contracts (the step kernel's block from :func:`repro_torch.kernels.rd.
launch_config`), verified by ``python -m repro_torch.analysis.kernelcheck``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .. import backend
from ..analysis.contracts import Axis, Interval, RangeClaim, choice, contract, span
from ..kernels import rd as rdk
from ..obs.session import device_profiler as _obs_device
from .instance import Assignment, AssignmentProblem
from .rd import RD_DEVICE_MAX_M, host_commit_walk, replica_deletion
from .reorder import commit_busy

__all__ = [
    "COUNTS",
    "initial_rd_state",
    "rd_slot_capacity",
    "replica_deletion_torch",
    "replica_deletion_torch_chain",
    "reset_counts",
    "run_rd",
]

I32 = torch.int32
# class hash = XOR of a random 57-bit word per server (0 for the pad id)
# and a 57-bit group term
_HASH_MASK = (1 << 57) - 1
_HASH_SEED = 0x5D1F
_GROUP_MULT = 0x6A09E667  # odd, < 2^31: grp · mult stays below 2^62
# iterations run between two host reads of a loop's exit flag: 1, 2, 4,
# ... up to this many (iterations past the exit are no-ops)
_CHECK_EVERY_MAX = 16

COUNTS = {"host_reruns": 0}
# (slot capacity, most live slots) of each problem the device solved
SLOT_PEAKS: list[tuple[int, int]] = []
# (slots C, row width A, iterations) of each run of the two loops
ITERATIONS: list[tuple[int, int, int]] = []


def reset_counts() -> None:
    for key in COUNTS:
        COUNTS[key] = 0
    SLOT_PEAKS.clear()
    ITERATIONS.clear()


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

    The reference's rule, capped at the step kernel's slot ceiling: the
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
    """Padded holder-row width: a power of two ≥ 2."""
    a_max = max((len(g.servers) for p in problems for g in p.groups), default=1)
    return _next_pow2(max(2, a_max))


def _drive(step, stop: torch.Tensor) -> int:
    """Run ``step`` until the flag ``stop`` (updated in place by the
    steps) is set, reading it on the host after 1, 2, 4, ... up to
    :data:`_CHECK_EVERY_MAX` iterations; returns the iterations run."""
    every, n = 1, 0
    while not bool(stop):
        for _ in range(every):
            step()
        n += every
        every = min(2 * every, _CHECK_EVERY_MAX)
    return n


def _init_state(
    busy0: torch.Tensor,
    mu: torch.Tensor,
    holders0: torch.Tensor,
    size0: torch.Tensor,
    cnt0: torch.Tensor,
    grp0: torch.Tensor,
    hash0: torch.Tensor,
    flags0: torch.Tensor,
) -> rdk.RDState:
    """The state before the first iteration.  ``holders0`` etc. carry
    ``C + 1`` rows (the last one spare, padded with ``M`` and empty);
    ``flags0`` is the initial ``[best, done, headroom, stop]``."""
    m_servers = busy0.shape[0]
    dev = busy0.device
    flat = holders0.long().reshape(-1)
    bsize = size0[:, None].expand_as(holders0).reshape(-1)
    bmulti = torch.where(cnt0 >= 2, size0, 0)[:, None].expand_as(holders0).reshape(-1)
    zeros = torch.zeros(m_servers + 1, dtype=I32, device=dev)
    load = zeros.index_add(0, flat, bsize)
    return rdk.RDState(
        holders=holders0,
        size=size0,
        cnt=cnt0,
        grp=grp0,
        hash=hash0,
        load=load,
        multi=zeros.index_add(0, flat, bmulti),
        busy_est=busy0 + _ceil_div(load[:m_servers], mu),
        busy0=busy0,
        mu=mu,
        words=torch.from_numpy(_server_hash_words(m_servers)).to(dev),
        targets0=torch.zeros(m_servers, dtype=torch.bool, device=dev),
        flags=flags0,
    )


def run_rd(st: rdk.RDState, step=None) -> rdk.RDState:
    """Run the whole RD (deletion + dedup) on ``st``, in place;
    ``step(state, dedup)`` runs one iteration (default the kernel's
    wrapper, :func:`repro_torch.kernels.rd.rd_step`).

    Deletion: one iteration = one strip, with the level sweep folded in:
    when the previous sweep's target set is exhausted, the same iteration
    opens a new sweep before selecting a target — what the host's lazy
    re-ranking heap realizes.  Dedup: one strip per iteration from the
    busiest multi-copy holder, (busy_est, busy0, id) descending — the
    reference's lexsort pick.
    """
    step = step or rdk.rd_step
    n = _drive(lambda: step(st, False), st.stop)
    st.stop.copy_(~(st.multi[:-1] > 0).any() | (st.headroom < 0))
    n += _drive(lambda: step(st, True), st.stop)
    ITERATIONS.append((st.c_slots, st.row_ids, n))
    return st


def _result(st: rdk.RDState) -> torch.Tensor:
    """size, cnt, grp, primary server (C each) and the headroom, as one
    int32 vector for a single device→host transfer."""
    c = st.c_slots
    return torch.cat(
        [st.size[:c], st.cnt[:c], st.grp[:c], st.holders[:c, 0], st.headroom]
    )


def _split(flat: np.ndarray) -> tuple[tuple[np.ndarray, ...], int]:
    """The inverse of :func:`_result`: (size, cnt, grp, srv), headroom."""
    c = (flat.shape[0] - 1) // 4
    return tuple(flat[i * c : (i + 1) * c] for i in range(4)), int(flat[-1])


# ---------------------------------------------------------------------------
# host adapters (numpy helpers copied from repro/core/rd_jax.py)


def _dense_instance(problem: AssignmentProblem, c_cap: int, a_pad: int) -> list[np.ndarray]:
    """Initial slot arrays, one slot per task group, padded to ``(C + 1,
    A)`` (the last row is the spare): holders, size, cnt, grp, the int64
    class hashes and the initial flags ``[best, done, headroom, stop]``."""
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
    words = _server_hash_words(m)
    hash0 = np.bitwise_xor.reduce(words[holders], axis=1)
    hash0 ^= (grp.astype(np.int64) * _GROUP_MULT) & _HASH_MASK
    headroom = int((size[:c_cap] == 0).sum())
    flags = np.array([-2, 0, headroom, 0], dtype=np.int32)
    return [holders, size, cnt, grp, hash0, flags]


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
            f"(the step kernel's per-server counts in shared memory), got {m} "
            "— use the host rd"
        )


_TORCH_DTYPES = {np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64}


def _to_device(*arrays: np.ndarray) -> list[torch.Tensor]:
    """One host→device copy for int32 and int64 arrays, returned as views
    (each starts on an 8-byte boundary of the buffer)."""
    parts, spans, at = [], [], 0
    for a in arrays:
        raw = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
        spans.append((at, raw.size, a.dtype, a.shape))
        pad = -raw.size % 8
        parts += [raw, np.zeros(pad, np.uint8)]
        at += raw.size + pad
    buf = torch.from_numpy(np.concatenate(parts)).to(backend.device())
    return [
        buf[start : start + n].view(_TORCH_DTYPES[dtype]).view(shape)
        for start, n, dtype, shape in spans
    ]


def _i32(a) -> np.ndarray:
    return np.asarray(a, dtype=np.int32)


def initial_rd_state(
    problem: AssignmentProblem,
    busy: torch.Tensor | None = None,
    capacity: int | None = None,
) -> rdk.RDState:
    """Device RD's state for one problem before its first iteration;
    ``busy`` is a device int32 vector of busy times (default: the
    problem's), ``capacity`` the slot count (default
    :func:`rd_slot_capacity`)."""
    c_cap = capacity or rd_slot_capacity(problem)
    arrays = _dense_instance(problem, c_cap, _a_pad([problem]))
    if busy is None:
        busy, mu, *slots = _to_device(_i32(problem.busy), _i32(problem.mu), *arrays)
    else:
        mu, *slots = _to_device(_i32(problem.mu), *arrays)
    return _init_state(busy, mu, *slots)


# ---------------------------------------------------------------------------
# kernelcheck geometry contracts (verified by repro_torch.analysis.kernelcheck).
# The geometry is what the adapter launches at: M servers, C slots (the
# rd_slot_capacity class), A ids a holder row (the padded group width).


def _rd_dispatch(geom: dict) -> str:
    # past RD_DEVICE_MAX_M (the step kernel's RD_MAX_M) the adapter refuses
    # and the host rd takes the problem
    return rdk.rd_route(geom["device"], geom["c"], geom["a"], geom["m"])


def _rd_ranges(geom: dict) -> list[RangeClaim]:
    """The step's claims plus the class hash's int64 words: the XOR of
    57-bit server words and the group term stay below the free-slot
    sentinel :data:`~repro_torch.kernels.rd.HASH_FREE`."""
    claims = rdk.rd_range_claims(geom["m"], geom["a"], geom.get("b", 1))
    word = Interval(0, _HASH_MASK)
    claims += [
        RangeClaim("class hash word (XOR of 57-bit words)", word, dtype="int64"),
        RangeClaim(
            "group hash term (grp · mult)",
            Interval(0, geom["c"]) * _GROUP_MULT,
            dtype="int64",
        ),
        RangeClaim(
            "free-slot hash sentinel headroom (HASH_FREE - hash)",
            Interval.const(rdk.HASH_FREE) - word,
            dtype="int64",
            positive=True,
        ),
    ]
    return claims


def _rd_sig(kind: str, m: int, c: int, a: int, b: int | None = None) -> tuple:
    sig = (kind, m, c, a)
    return sig if b is None else sig + (b,)


_RD_AXES = (
    span("m", 2, RD_DEVICE_MAX_M, boundaries=(rdk.MIN_LANES, 4096, RD_DEVICE_MAX_M),
         past=(RD_DEVICE_MAX_M + 1, 1 << 16)),
    Axis("c", (rdk.MIN_LANES, 1024, 4096, rdk.RD_MAX_C)),
    Axis("a", (2, 4, 16, rdk.RD_MAX_ROW_IDS, 2 * rdk.RD_MAX_ROW_IDS)),
    choice("device", "cuda", "cpu"),
)


def _rd_abstract(geom: dict):
    return rdk.rd_step, (rdk.zero_state(geom["c"], geom["a"], geom["m"]), False)


@contract(
    "rd_torch.device",
    axes=_RD_AXES,
    backends=("kernel", "wide", "plain", "host"),
    device_backends=("kernel",),
    dispatch=_rd_dispatch,
    smem=lambda geom: rdk.launch_config(geom["c"], geom["m"]),
    ranges=_rd_ranges,
    signature=lambda geom: _rd_sig("rd-device", geom["m"], geom["c"], geom["a"]),
    max_signatures=256,  # m lattice points × slot classes × row widths
    abstract=_rd_abstract,
    eval_points=2,
    notes="single-problem device RD: one step launch a loop iteration; "
    "more than RD_DEVICE_MAX_M servers route to the host rd, a slot "
    "overflow re-runs on the host at run time, rows past 64 ids take the "
    "plain iteration on the card",
)
def replica_deletion_torch(problem: AssignmentProblem) -> Assignment:
    """Host-facing RD with its iterations on the device (registered as
    ``"rd_torch"``); the same assignment as the host
    :func:`repro_torch.core.rd.replica_deletion`.  A slot-capacity
    overflow (see :func:`rd_slot_capacity`) re-runs the problem on the
    host and counts one ``host_reruns``."""
    _check_servers(problem.n_servers)
    if problem.n_tasks == 0:
        result = Assignment(alloc=[], phi=0)
        result.phi = result.realized_phi(problem)
        return result
    prof = _obs_device()
    t0 = prof.start() if prof is not None else 0.0
    st = run_rd(initial_rd_state(problem))
    parts, headroom = _split(_result(st).cpu().numpy())
    if prof is not None:  # past the host read; sig = the kernelcheck key
        sig = _rd_sig("rd-device", problem.n_servers, st.c_slots, st.row_ids)
        prof.record("rd-device", sig, t0, fallback=headroom < 0 or st.route == "wide")
    if headroom < 0:
        COUNTS["host_reruns"] += 1
        return replica_deletion(problem)
    c = parts[0].shape[0]
    SLOT_PEAKS.append((c, c - headroom))
    return _decode(problem, *parts)


@contract(
    "rd_torch.chain",
    axes=(*_RD_AXES, choice("b", 1, 2, 7, 32, rdk.RD_ENV_CHAIN_JOBS_MAX)),
    backends=("kernel", "wide", "plain", "host"),
    device_backends=("kernel",),
    dispatch=_rd_dispatch,
    smem=lambda geom: rdk.launch_config(geom["c"], geom["m"]),
    ranges=_rd_ranges,
    signature=lambda geom: _rd_sig("rd-chain", geom["m"], geom["c"], geom["a"], geom["b"]),
    max_signatures=1280,  # × burst lengths
    abstract=_rd_abstract,
    eval_points=2,
    notes="same-slot RD burst: the jobs one after another on the device, "
    "eq. 2 committed between them; an overflow of any job re-walks the "
    "whole burst on the host",
)
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
    prof = _obs_device()
    t0 = prof.start() if prof is not None else 0.0
    (busy,) = _to_device(_i32(base))
    outs = []
    c_max, a_max, wide = 0, 0, False
    for p in problems:
        st = run_rd(initial_rd_state(p, busy))
        c_max, a_max = max(c_max, st.c_slots), max(a_max, st.row_ids)
        wide |= st.route == "wide"
        if int(st.headroom) < 0:
            # an overflowed job corrupts every later job's busy carry:
            # walk the burst on the host (identical assignments)
            if prof is not None:
                sig = _rd_sig("rd-chain", m, c_max, a_max, len(problems))
                prof.record("rd-chain", sig, t0, fallback=True)
            COUNTS["host_reruns"] += 1
            return host_commit_walk(problems)
        loads = torch.zeros(m + 1, dtype=I32, device=busy.device)
        loads.index_add_(0, st.holders[:-1, 0], st.size[:-1])
        loads = loads[:m]
        busy = busy + torch.where(loads > 0, _ceil_div(loads, st.mu), 0)  # eq. 2
        outs.append(_result(st))
    flat = torch.cat(outs).cpu().numpy()
    if prof is not None:  # past the host read; sig = the kernelcheck key
        sig = _rd_sig("rd-chain", m, c_max, a_max, len(problems))
        prof.record("rd-chain", sig, t0, fallback=wide)
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
