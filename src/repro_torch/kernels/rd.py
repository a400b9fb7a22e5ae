"""The RD step kernel's wrapper, its plain PyTorch version, and counts.

Counterpart of ``repro/kernels/rd.py``.  There the TPU kernel
``_rd_strip_kernel`` (launched by ``_rd_strip_call``) sorts one strip's
slot lanes by the deletion key and walks their member counts against the
quota, and the ``lax.while_loop`` bodies of ``repro/core/rd_jax.py``
around it pick the target server and re-home the deleted members.  Here
one launch of ``csrc/rd_step.cu`` carries out one whole iteration of
device RD's deletion loop or of its dedup loop (:mod:`repro_torch.core.
rd_torch`): the target pick, the strip, the re-homing and the server
deltas, on the buffers of an :class:`RDState`, updated in place.  It is
built from source at first use (:mod:`._build`).

One iteration, as both versions here carry it out:

- **Target pick.**  Deletion: when the sweep's targets are used up, open
  a new sweep (the highest busy level among servers with load, the
  servers at it, and the sole-copy exit check); then the target is the
  first argmax of ``busy0`` among the sweep's targets whose peek count
  (the largest replica count of an active class on the server) is the
  largest.  Dedup: the last argmax of ``busy0`` among the busiest servers
  that still hold multi-copy members.
- **The strip of server m.**  Candidates are the active slots on ``m``
  with two or more replicas, sorted by ``(-count, alt, holder row, group,
  slot)`` (alt: the least initial busy time over the row's other
  holders); their member counts are walked against the quota
  ``((load_m - 1) mod μ_m) + 1``, int32 with wrapping (:func:`rd_strip_
  takes_plain` is that sort and walk).  The quota is 0 when the loop has
  exited, so an iteration past the exit moves nothing.
- **Re-homing.**  A mover's members join the lowest live slot whose
  class hash equals their new class's, confirmed by its group and holder
  row; else the i-th new class in slot order takes the i-th free slot,
  and past the free slots the move only drives the headroom negative
  (the result is then discarded and re-run on the host).
- **Deltas.**  ``multi``, ``load`` and ``busy_est`` of the server, the
  sole-copy count of each count-2 mover's last holder, the headroom, and
  the loop's carry and exit flag.

- :func:`rd_step` launches the kernel for CUDA state, or raises; it
  takes the plain version only for state on the CPU, or, on the card,
  for holder rows wider than :data:`RD_MAX_ROW_IDS` (the counted rule
  of :func:`resolve_rd_step`).
- :func:`rd_step_plain` is the same iteration in plain PyTorch.

A launch's threads and dynamic shared memory come from
:func:`launch_config`, the one formula the launcher passes to the launch
and the ``rd.step`` contract below (and the ``rd_torch.*`` contracts of
:mod:`repro_torch.core.rd_torch`) declare, verified without a card by
``python -m repro_torch.analysis.kernelcheck``.

``COUNTS`` holds plain integers: ``rd_step`` counts kernel launches,
``plain`` counts iterations of the plain version, and ``wide`` the
plain iterations the rule sent past the kernel's row ceiling on the
card.  :func:`reset_counts` zeroes them.  ``LAUNCH_CONFIGS`` maps each
``(C, A, M)`` launched since the process started (or since the caller
cleared it) to the :class:`~repro_torch.analysis.contracts.BlockConfig`
it was launched with.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ..analysis.contracts import Axis, BlockConfig, Interval, RangeClaim, contract, span
from . import _build

__all__ = [
    "BIG",
    "COUNTS",
    "HASH_FREE",
    "LAUNCH_CONFIGS",
    "MIN_LANES",
    "RD_MAX_C",
    "RD_MAX_M",
    "RD_MAX_ROW_IDS",
    "RDState",
    "kernel_attributes",
    "launch_config",
    "rd_step",
    "rd_step_plain",
    "rd_strip_takes_plain",
    "reset_counts",
    "resolve_rd_step",
]

BIG = 2**30  # non-candidate sentinel of the primary key; alt of the pad id
I32_MIN = -(2**31)
MIN_LANES = 128  # the reference's lane floor (its slot capacity is >= 128)
# the slot ceiling: the candidate sort holds 12 bytes a slot in one
# block's shared memory (192 KB at 16,384 slots)
RD_MAX_C = 1 << 14
# the widest holder row the kernel takes: a warp holds a row, two ids a lane
RD_MAX_ROW_IDS = 64
# the server ceiling: the peek counts of M + 1 ids in shared memory
RD_MAX_M = (1 << 15) - 1
HASH_FREE = (1 << 63) - 1  # sorts after every class hash (57-bit words)

COUNTS = {"rd_step": 0, "plain": 0, "wide": 0}
# (C, A, M) -> the block the step kernel launched with
LAUNCH_CONFIGS: dict[tuple[int, int, int], BlockConfig] = {}

RD_THREADS = 1024  # csrc/rd_step.cu's kThreads: one block of 32 warps
# the kernel's static shared memory: csrc/rd_step.cu's Scalars (per-warp
# 64- and 32-bit reductions and scan totals, four counts; 528 bytes),
# held against the compiled kernel's attributes by chip_smoke.py
RD_STATIC_SMEM = 528


def reset_counts() -> None:
    for key in COUNTS:
        COUNTS[key] = 0


def launch_config(c_slots: int, m_servers: int) -> BlockConfig:
    """The block one RD iteration launches with: :data:`RD_THREADS`
    threads, and as dynamic shared memory the peek counts (M + 1 ints)
    or the candidates' 64-bit keys and slots (12 bytes a slot), whichever
    is larger, rounded up to 16 bytes.  The launcher passes these to the
    launch, and the kernel contracts declare them."""
    need = max(4 * (m_servers + 1), 12 * c_slots)
    return BlockConfig(
        static_smem=RD_STATIC_SMEM, dynamic_smem=(need + 15) & ~15, threads=RD_THREADS
    )


def kernel_attributes() -> tuple[int, int]:
    """(static shared memory, max threads a block) of the compiled step
    kernel; needs the card."""
    fn = _build.library("rd_step").rd_step_kernel_attributes
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    static, threads = ctypes.c_int(), ctypes.c_int()
    err = fn(ctypes.byref(static), ctypes.byref(threads))
    if err != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed with CUDA error {err}")
    return static.value, threads.value


def resolve_rd_step(device_type: str, row_ids: int) -> str:
    """The route of one iteration: ``"kernel"`` (CUDA state with holder
    rows of at most :data:`RD_MAX_ROW_IDS` ids), ``"wide"`` (CUDA state
    past that ceiling: the plain version on the card, counted), or
    ``"plain"`` (state on the CPU), as the reference's ``_resolve_device``
    sends geometries past its kernel's key rows to its jnp strip."""
    if device_type != "cuda":
        return "plain"
    return "kernel" if row_ids <= RD_MAX_ROW_IDS else "wide"


# ---- the state ------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class RDState:
    """The buffers one RD iteration reads and updates in place.

    Slot buffers carry one spare row (index ``C``) and server buffers one
    spare lane (index ``M``, the pad id): the targets of the reference's
    dropped scatters.  ``flags`` is ``[best, done, headroom, stop]``: the
    deletion sweep's busy level and exit flag, the fewest free slots left
    after a strip took its new ones (< 0 is an overflow), and the exit
    flag of the loop the last iteration belongs to.
    """

    holders: torch.Tensor  # (C+1, A) int32, rows sorted ascending, pad = M
    size: torch.Tensor  # (C+1,) int32 members (0 = free slot)
    cnt: torch.Tensor  # (C+1,) int32 replica count
    grp: torch.Tensor  # (C+1,) int32 group id
    hash: torch.Tensor  # (C+1,) int64 class hash of (grp, holders)
    load: torch.Tensor  # (M+1,) int32
    multi: torch.Tensor  # (M+1,) int32 multi-copy members per server
    busy_est: torch.Tensor  # (M,) int32 busy0 + ceil(load / mu)
    busy0: torch.Tensor  # (M,) int32 initial busy times (read only)
    mu: torch.Tensor  # (M,) int32 service rates >= 1 (read only)
    words: torch.Tensor  # (M+1,) int64 class-hash word per id, 0 for M
    targets0: torch.Tensor  # (M,) bool the deletion sweep's targets
    flags: torch.Tensor  # (4,) int32 best, done, headroom, stop

    def __post_init__(self) -> None:
        _check(self)

    @property
    def c_slots(self) -> int:
        return self.holders.shape[0] - 1

    @property
    def m_servers(self) -> int:
        return self.busy0.shape[0]

    @property
    def row_ids(self) -> int:
        return self.holders.shape[1]

    @property
    def best(self) -> torch.Tensor:
        return self.flags[0:1]

    @property
    def done(self) -> torch.Tensor:
        return self.flags[1:2]

    @property
    def headroom(self) -> torch.Tensor:
        return self.flags[2:3]

    @property
    def stop(self) -> torch.Tensor:
        return self.flags[3:4]

    @functools.cached_property
    def route(self) -> str:
        return resolve_rd_step(self.holders.device.type, self.row_ids)

    def buffers(self) -> dict[str, torch.Tensor]:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}

    def clone(self) -> RDState:
        return RDState(**{k: v.clone() for k, v in self.buffers().items()})


def _check(st: RDState) -> None:
    bufs = st.buffers()
    for name, t in bufs.items():
        want = {"hash": torch.int64, "words": torch.int64, "targets0": torch.bool}.get(
            name, torch.int32
        )
        if t.dtype != want:
            raise TypeError(f"rd_step: {name} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"rd_step: {name} must be contiguous")
        if t.device != st.holders.device:
            raise ValueError("rd_step: every buffer must lie on one device")
    if st.holders.dim() != 2:
        raise ValueError(f"rd_step: holders must be (C+1, A), got {tuple(st.holders.shape)}")
    c, a, m = st.c_slots, st.row_ids, st.busy0.shape[0]
    if c < MIN_LANES or c & (c - 1) or c > RD_MAX_C:
        raise ValueError(
            f"rd_step: slots must be a power of two in [{MIN_LANES}, {RD_MAX_C}], got {c}"
        )
    if a < 2 or a & (a - 1):
        raise ValueError(f"rd_step: holder rows must be a power of two >= 2 wide, got {a}")
    if not 1 <= m <= RD_MAX_M:
        raise ValueError(f"rd_step: servers must be in [1, {RD_MAX_M}], got {m}")
    shapes = {
        "size": (c + 1,), "cnt": (c + 1,), "grp": (c + 1,), "hash": (c + 1,),
        "load": (m + 1,), "multi": (m + 1,), "busy_est": (m,), "mu": (m,),
        "words": (m + 1,), "targets0": (m,), "flags": (4,),
    }
    for name, shape in shapes.items():
        if tuple(bufs[name].shape) != shape:
            raise ValueError(
                f"rd_step: {name} of shape {tuple(bufs[name].shape)}, expected {shape}"
            )
    if st.holders.device.type == "cuda" and st.holders.device.index != torch.cuda.current_device():
        raise ValueError(
            f"rd_step: state on {st.holders.device} but the current device is "
            f"cuda:{torch.cuda.current_device()}"
        )


# ---- the plain version ----------------------------------------------------------


def rd_strip_takes_plain(
    keys: torch.Tensor, size: torch.Tensor, quota: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The strip's sort and walk (the TPU kernel's contract) in plain
    PyTorch, for any ``(R, C)`` int32 key block.

    ``keys`` rows are most significant first (masked ``-count`` with
    :data:`BIG` for non-candidates, alt, the holder row's ids, group);
    returns ``(take_sorted, idx)``: ``idx`` sorts the lanes by the key
    rows with the lane index as the last tie, ``take_sorted = clip(quota
    - prev, 0, s)`` with ``s`` the sorted member counts masked to
    candidates and ``prev`` their exclusive prefix sum.  ``torch`` has no
    lexsort: stable argsorts chained from the least significant row
    realize it.  Every intermediate stays int32, so sums wrap exactly as
    in the reference and the kernel.
    """
    i32 = torch.int32
    n_rows, n_lanes = keys.shape
    order = torch.arange(n_lanes, device=keys.device)
    for r in range(n_rows - 1, -1, -1):
        row = keys[r].index_select(0, order)
        order = order.index_select(0, torch.argsort(row, stable=True))
    cand = keys[0].index_select(0, order) != BIG
    s = torch.where(cand, size.index_select(0, order), 0)
    prev = torch.cumsum(s, 0, dtype=i32) - s
    take = torch.minimum((quota.reshape(1) - prev).clamp(min=0), s)
    return take, order.to(i32)


def _ceil_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return -(-a // b)


def _refine_max(mask: torch.Tensor, key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Narrow ``mask`` to the entries attaining ``max(key over mask)``."""
    best = torch.where(mask, key, I32_MIN).amax()
    return mask & (key == best), best


def _peek_vec(st: RDState, active_cnt: torch.Tensor) -> torch.Tensor:
    """Largest replica count among active classes, per server."""
    holders = st.holders[:-1]
    vals = active_cnt[:, None].expand_as(holders).reshape(-1)
    peek = torch.zeros(st.m_servers + 1, dtype=torch.int32, device=vals.device)
    peek.scatter_reduce_(0, holders.reshape(-1).long(), vals, "amax")
    return peek[:-1]


def _strip(
    st: RDState, m: torch.Tensor, gate: torch.Tensor, active_cnt: torch.Tensor
) -> torch.Tensor:
    """The strip of server ``m`` (a ``(1,)`` index) with quota 0 unless
    ``gate``; updates ``st`` and returns the members removed."""
    i32 = torch.int32
    c_slots, m_servers = st.c_slots, st.m_servers
    holders, size, cnt = st.holders[:-1], st.size[:-1], st.cnt[:-1]
    grp, hsh = st.grp[:-1], st.hash[:-1]
    load_m = st.load.index_select(0, m)
    mu_m = st.mu.index_select(0, m)
    quota = torch.where(gate, (load_m - 1) % mu_m + 1, 0)

    is_m = holders == m  # (C, A)
    cand = is_m.any(1) & (active_cnt >= 2)
    busy_ext = torch.cat([st.busy0, st.busy0.new_full((1,), BIG)])
    alt = torch.where(is_m, BIG, busy_ext[holders.long()]).amin(1)
    neg_key = torch.where(cand, -cnt, BIG)
    keys = torch.cat([neg_key[None], alt[None], holders.T, grp[None]])
    take_sorted, order = rd_strip_takes_plain(keys, size, quota)
    # order is a permutation, so the scatter writes every lane
    take = torch.empty_like(take_sorted).scatter_(0, order.long(), take_sorted)
    removed = take.sum(dtype=i32).reshape(1)

    # spun holder row: drop the (unique) entry equal to m, shift left
    pad = holders.new_full((c_slots, 1), m_servers)
    spun = torch.where(is_m.cumsum(1) > 0, torch.cat([holders[:, 1:], pad], 1), holders)
    spun_hash = hsh ^ st.words.index_select(0, m)
    # home: the lowest live slot with the new class's hash (a stable sort
    # puts equal hashes in slot order), confirmed by group and row
    live = size > 0
    by_hash, slot_of = torch.where(live, hsh, HASH_FREE).sort(stable=True)
    at = torch.searchsorted(by_hash, spun_hash).clamp_(max=c_slots - 1)
    home = slot_of.index_select(0, at)
    mv = take > 0
    merge = (
        mv
        & (by_hash.index_select(0, at) == spun_hash)
        & live.index_select(0, home)
        & (grp.index_select(0, home) == grp)
        & (holders.index_select(0, home) == spun).all(1)
    )
    # else the i-th new class in slot order takes the i-th free slot
    new = mv & ~merge
    free = size == 0
    free_rank = torch.cumsum(free, 0, dtype=i32)
    new_rank = torch.cumsum(new, 0, dtype=i32)
    n_free = free_rank[-1:]
    st.headroom.copy_(torch.minimum(st.headroom, n_free - new_rank[-1:]))
    free_ids = torch.full((c_slots + 1,), c_slots, dtype=torch.long, device=size.device)
    free_ids.index_copy_(
        0,
        torch.where(free, free_rank - 1, c_slots).long(),
        torch.arange(c_slots, device=size.device),
    )
    tgt = torch.where(
        new,
        free_ids.index_select(0, (new_rank - 1).clamp(min=0).long()),
        torch.where(merge, home, c_slots),
    )
    # rows without a slot to write rewrite the spare row with itself
    write = merge | (new & (new_rank <= n_free))
    into = torch.where(write, tgt, c_slots)
    c2 = mv & (cnt == 2)
    spare = c_slots
    st.holders.index_copy_(0, into, torch.where(write[:, None], spun, st.holders[spare]))
    st.hash.index_copy_(0, into, torch.where(write, spun_hash, st.hash[spare]))
    st.grp.index_copy_(0, into, torch.where(write, grp, st.grp[spare]))
    st.cnt.index_copy_(0, into, torch.where(write, cnt - 1, st.cnt[spare]))
    size.sub_(take)
    st.size.index_add_(0, tgt, take)

    # server deltas; members of a count-2 class became sole-copy on their
    # last holder
    neg_removed = -removed
    st.multi.index_add_(0, m, neg_removed)
    st.multi.index_add_(0, torch.where(c2, spun[:, 0], m_servers), -take)
    st.load.index_add_(0, m, neg_removed)
    busy_m = st.busy0.index_select(0, m) + _ceil_div(load_m + neg_removed, mu_m)
    st.busy_est.index_copy_(0, m, busy_m)
    return removed


def rd_step_plain(st: RDState, dedup: bool) -> None:
    """One iteration of the deletion loop (``dedup`` false) or of the
    dedup loop, in plain PyTorch, on any device; updates ``st``."""
    COUNTS["plain"] += 1
    m_servers = st.m_servers
    load, multi, busy_est, busy0 = st.load[:-1], st.multi[:-1], st.busy_est, st.busy0
    active_cnt = torch.where(st.size[:-1] > 0, st.cnt[:-1], 0)
    if dedup:
        # the busiest multi-copy holder, (busy_est, busy0, id) descending
        mask = multi > 0
        gate = mask.any().reshape(1)
        mask, _ = _refine_max(mask, busy_est)
        pick = torch.where(mask, busy0, I32_MIN).flip(0).argmax()
        m = (m_servers - 1 - pick).reshape(1)
    else:
        # a sweep's targets are the servers at its busy level; when none
        # is left at it, the same iteration opens the next sweep
        held = load > 0
        valid = st.targets0 & held & (busy_est == st.best)
        new_sweep = ~valid.any()
        nbest = torch.where(held, busy_est, -1).amax()
        ntargets = held & (busy_est == nbest)
        best = torch.where(new_sweep, nbest, st.best)
        valid = torch.where(new_sweep, ntargets, valid)
        st.targets0.copy_(torch.where(new_sweep, ntargets, st.targets0))
        # sweep-entry exit: a target holding only sole-copy tasks means
        # the max busy level cannot drop any further
        done_now = new_sweep & ((nbest < 0) | (ntargets & (multi == 0)).any())
        mask, p = _refine_max(valid, _peek_vec(st, active_cnt))
        # the argmax of busy0 over the mask is the reference's second
        # refinement plus its first-True pick
        m = torch.where(mask, busy0, I32_MIN).argmax().reshape(1)
        stop = (st.done != 0) | done_now | (p <= 1)
        gate = ~stop
    removed = _strip(st, m, gate, active_cnt)
    if dedup:
        st.stop.copy_(~(multi > 0).any() | (st.headroom < 0))
    else:
        # a strip that ran out of quota drained m's multi-copy classes;
        # any still-max server with no multi-copy tasks ends the phase
        st.best.copy_(best)
        tail = (removed == 0) | ((load > 0) & (busy_est == best) & (multi == 0)).any()
        done = stop | (gate & tail)
        st.done.copy_(done)
        st.stop.copy_(done | (st.headroom < 0))


# ---- the kernel contract -------------------------------------------------------
#
# kernelcheck geometry contract (verified by repro_torch.analysis.kernelcheck).
# The admissible input envelope is the reference's (repro/core/rd_jax.py
# RD_ENV_*): replica counts from per-task holder sets, member counts
# summing to at most RD_ENV_TASKS_MAX per job, busy times up to
# RD_ENV_BUSY0_MAX, μ up to RD_ENV_MU_MAX, bursts up to
# RD_ENV_CHAIN_JOBS_MAX jobs.

RD_ENV_BUSY0_MAX = 1 << 20  # pre-burst busy time per server
RD_ENV_TASKS_MAX = 1 << 20  # tasks per job
RD_ENV_MU_MAX = 1 << 4  # per-server tasks/slot (μ)
RD_ENV_CHAIN_JOBS_MAX = 64  # jobs per chained same-slot burst


def rd_route(device_type: str, c_slots: int, row_ids: int, m_servers: int) -> str:
    """The route of an iteration at a geometry: :func:`resolve_rd_step`'s
    ``kernel`` / ``wide`` / ``plain``, or ``host`` past the slot or server
    ceilings — the adapters never launch there: the slot capacity is
    capped at :data:`RD_MAX_C` (an overflow re-runs the problem on the
    host rd) and ``rd_torch`` refuses more than :data:`RD_MAX_M`
    servers."""
    if c_slots > RD_MAX_C or m_servers > RD_MAX_M:
        return "host"
    return resolve_rd_step(device_type, row_ids)


def rd_range_claims(m_servers: int, row_ids: int, chain_jobs: int = 1) -> list[RangeClaim]:
    """The iteration's int32 claims over the envelope: holder ids and the
    pad id, the 64-bit candidate key's two 32-bit words, the quota walk,
    the per-server scatters and the eq. 2 carry of a chain."""
    server_id = Interval(0, m_servers)  # holder ids, pad id = M
    neg_count = Interval(-row_ids, 0)
    tasks = Interval(0, RD_ENV_TASKS_MAX)
    busy0 = Interval(0, RD_ENV_BUSY0_MAX)
    # eq. 2 carry: each admitted job raises a server's busy estimate by
    # at most ⌈load/μ⌉ ≤ load ≤ its task total
    busy_est = busy0 + Interval(0, chain_jobs) * tasks
    return [
        RangeClaim("holder id field (pad id = M)", server_id, bits=15),
        RangeClaim("candidate key high word (-count)", neg_count),
        RangeClaim(
            "non-candidate sentinel headroom (BIG - max real -count)",
            Interval.const(BIG) - neg_count,
            positive=True,
        ),
        RangeClaim("candidate key low word (alt: busy or BIG)", Interval(0, BIG)),
        RangeClaim("member-count prefix sum", tasks),
        RangeClaim("quota clamp (quota - prev)", Interval(-RD_ENV_TASKS_MAX, RD_ENV_TASKS_MAX)),
        RangeClaim("strip quota ((load-1) mod μ + 1)", Interval(1, RD_ENV_MU_MAX)),
        RangeClaim("per-server load scatter", tasks),
        RangeClaim("eq. 2 busy estimate", busy_est),
        RangeClaim(
            "sole-copy alt sentinel headroom (BIG - busy_est)",
            Interval.const(BIG) - busy_est,
            positive=True,
        ),
    ]


def zero_state(c_slots: int, row_ids: int, m_servers: int) -> RDState:
    """An empty state on the CPU at a geometry (every slot free, μ = 1):
    what a contract's abstract call puts through the wrapper's checks and
    the plain iteration."""
    i32 = torch.int32
    return RDState(
        holders=torch.full((c_slots + 1, row_ids), m_servers, dtype=i32),
        size=torch.zeros(c_slots + 1, dtype=i32),
        cnt=torch.zeros(c_slots + 1, dtype=i32),
        grp=torch.zeros(c_slots + 1, dtype=i32),
        hash=torch.zeros(c_slots + 1, dtype=torch.int64),
        load=torch.zeros(m_servers + 1, dtype=i32),
        multi=torch.zeros(m_servers + 1, dtype=i32),
        busy_est=torch.zeros(m_servers, dtype=i32),
        busy0=torch.zeros(m_servers, dtype=i32),
        mu=torch.ones(m_servers, dtype=i32),
        words=torch.zeros(m_servers + 1, dtype=torch.int64),
        targets0=torch.zeros(m_servers, dtype=torch.bool),
        flags=torch.tensor([-2, 0, c_slots, 0], dtype=i32),
    )


# ---- the kernel -----------------------------------------------------------------


@functools.cache
def _launcher():
    fn = _build.library("rd_step").rd_step_launch
    ptr = ctypes.c_void_p
    fn.argtypes = [ptr] * 14 + [ctypes.c_int] * 6 + [ptr]
    fn.restype = ctypes.c_int
    return fn


def _args(st: RDState) -> tuple[tuple, BlockConfig]:
    """The launch's pointer and size arguments, with the kernel's per-mover
    scratch (five int32 slot vectors), and its block, made at the state's
    first launch."""
    args = st.__dict__.get("_launch_args")
    if args is None:
        scratch = torch.empty(5 * st.c_slots, dtype=torch.int32, device=st.holders.device)
        ptrs = [t.data_ptr() for t in st.buffers().values()]
        cfg = launch_config(st.c_slots, st.m_servers)
        args = ((*ptrs, scratch.data_ptr(), st.c_slots, st.row_ids, st.m_servers), cfg)
        st.__dict__["_launch_args"] = args
        st.__dict__["_scratch"] = scratch  # keeps the scratch alive with the state
    return args


@contract(
    "rd.step",
    axes=(
        Axis("c", (128, 256, 1024, 4096, RD_MAX_C), past=(RD_MAX_C * 2,)),
        Axis("a", (2, 4, 16, 32, RD_MAX_ROW_IDS, 2 * RD_MAX_ROW_IDS)),
        span("m", 1, RD_MAX_M, boundaries=(4096, RD_MAX_M), past=(RD_MAX_M + 1,)),
        Axis("device", ("cuda", "cpu")),
    ),
    backends=("kernel", "wide", "plain", "host"),
    device_backends=("kernel",),
    dispatch=lambda geom: rd_route(geom["device"], geom["c"], geom["a"], geom["m"]),
    smem=lambda geom: launch_config(geom["c"], geom["m"]),
    ranges=lambda geom: rd_range_claims(geom["m"], geom["a"]),
    signature=lambda geom: ("rd-step", geom["c"], geom["a"], geom["m"]),
    max_signatures=192,  # slot classes × row widths × server counts: each sets the state
    abstract=lambda geom: (rd_step, (zero_state(geom["c"], geom["a"], geom["m"]), False)),
    eval_points=3,
    notes="one RD iteration (target pick, strip sort and walk, re-homing, "
    "deltas) in one block; rows past 64 ids take the plain iteration on "
    "the card (counted as wide); slots past RD_MAX_C or servers past "
    "RD_MAX_M never reach it (the host rd takes them)",
)
def rd_step(st: RDState, dedup: bool) -> None:
    """One RD iteration on ``st``: the CUDA kernel for CUDA state (one
    launch on the current stream, no synchronisation); the plain version
    for CPU state, or on the card past :data:`RD_MAX_ROW_IDS` (counted as
    ``wide``)."""
    route = st.route
    if route != "kernel":
        if route == "wide":
            COUNTS["wide"] += 1
        rd_step_plain(st, dedup)
        return
    args, cfg = _args(st)
    err = _launcher()(
        *args,
        int(dedup),
        cfg.dynamic_smem,
        cfg.threads,
        torch.cuda.current_stream(st.holders.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"rd_step kernel launch failed with CUDA error {err} (C={st.c_slots}, "
            f"A={st.row_ids}, M={st.m_servers})"
        )
    COUNTS["rd_step"] += 1
    LAUNCH_CONFIGS[st.c_slots, st.row_ids, st.m_servers] = cfg
