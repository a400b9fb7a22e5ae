"""The water-level kernels' wrappers, their plain PyTorch versions, and counts.

Counterpart of ``repro/kernels/waterlevel.py``.  The TPU kernel
``_waterlevel_kernel`` (launched by ``_waterlevel_call_padded`` and its
``(B,)``-grid twin ``_waterlevel_call_padded_batch``) is
``csrc/waterlevel.cu`` here, built from source at first use
(:mod:`._build`).  That source holds two kernels on one row step:

- K1/K2 (:func:`waterlevel_sorted`) keeps the TPU kernel's contract:
  pre-masked int32 rows ``b``, ``w`` of shape ``(B, n_lanes)`` (pad and
  masked lanes carry ``b = BIG``, ``w = 0``) and ``demand`` of shape
  ``(B,)`` → ``(level (B,), take_sorted (B, n_lanes), idx_sorted (B,
  n_lanes))``: the water level, the Alg. 2 takes in ascending ``(busy,
  lane)`` order, and the permutation that order applies.
  :func:`waterlevel_sorted_plain` is the same function in plain PyTorch
  (argsort + cumsum); it accepts any row width, so the ``torch`` route
  runs it on unpadded rows as well.
- The fused water-filling kernel (:func:`wf_groups`, :func:`wf_chain`)
  runs the whole K-group scan, and the B-job eq. 2 chain, in one launch:
  raw busy / μ rows, ``(K, M)`` bool masks and ``(K,)`` demands per
  problem → allocations in lane order, levels (the minimum available busy
  where demand ≤ 0) and Φ.  Its plain versions, :func:`wf_groups_plain`
  and :func:`wf_chain_plain`, are Python loops over
  :func:`waterlevel_sorted_plain`.

Rows up to 16,384 lanes (K1) or 8,192 (the fused kernel) stay in a
block's shared memory; wider rows run on an L2 scratch the wrapper
allocates at the size the source states.  A block's threads and dynamic
shared memory come from :func:`launch_config`, the one formula the
launchers pass to the launch and the kernel contracts declare
(``waterlevel.kernel`` and ``waterlevel.kernel-batch`` here, the
``wf_torch.*`` contracts of :mod:`repro_torch.core.wf_torch`), verified
without a card by ``python -m repro_torch.analysis.kernelcheck``.

Each wrapper launches its kernel for a CUDA tensor, or raises; it takes
the plain version only for a tensor on the CPU.

``COUNTS`` holds plain integers: ``waterlevel`` and ``waterlevel_batch``
count K1/K2 launches over one row and over several rows, ``wf_groups``
and ``wf_chain`` count fused launches, ``wf_group_steps`` the group
steps (one per problem row and group) done inside them, and ``plain``
counts calls of :func:`waterlevel_sorted_plain`.  :func:`reset_counts`
zeroes them.  ``LAUNCH_CONFIGS`` maps each ``(kernel, n_lanes)``
launched since the process started (or since the caller cleared it) to
the :class:`~repro_torch.analysis.contracts.BlockConfig` it was launched
with.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import backend
from ..analysis.contracts import BlockConfig, Interval, RangeClaim, choice, contract, span
from . import _build

__all__ = [
    "BIG",
    "COUNTS",
    "LAUNCH_CONFIGS",
    "MAX_LANES",
    "kernel_attributes",
    "launch_config",
    "n_lanes_for",
    "reset_counts",
    "resolve_waterlevel",
    "waterlevel_sorted",
    "waterlevel_sorted_plain",
    "wf_chain",
    "wf_chain_plain",
    "wf_groups",
    "wf_groups_plain",
]

BIG = 2**30  # masked and pad lanes sort past every real lane
LANES = 128  # minimum padded width (the reference's lane floor)
MAX_LANES = 1 << 15  # kernel ceiling, the reference's PALLAS_MAX_M

COUNTS = {
    "waterlevel": 0,
    "waterlevel_batch": 0,
    "wf_groups": 0,
    "wf_chain": 0,
    "wf_group_steps": 0,
    "plain": 0,
}
# (kernel, n_lanes) -> the block it launched with ("waterlevel": K1/K2,
# "wf_fused": the fused water-filling kernel)
LAUNCH_CONFIGS: dict[tuple[str, int], BlockConfig] = {}

MAX_THREADS = 1024
SMEM_MAX_LANES = 1 << 14  # K1/K2 rows held in shared memory up to here
FUSED_SMEM_MAX_LANES = 1 << 13  # the fused kernel's rows, likewise
# both kernels' static shared memory: csrc/waterlevel.cu's RowShared
# (per-warp scan totals, the scan's selection and the one-warp step's
# live lanes; 800 bytes), held against the compiled kernels' attributes
# by chip_smoke.py
STATIC_SMEM = 800


def reset_counts() -> None:
    for key in COUNTS:
        COUNTS[key] = 0


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def n_lanes_for(m: int) -> int:
    """Padded row width for ``m`` servers."""
    return max(LANES, _next_pow2(m))


def _row_bytes(n_lanes: int, fused: bool) -> int:
    """One row's buffers in csrc/waterlevel.cu's layout: sorted keys (8 B)
    and w (4 B), the fused kernel's raised, committed and load vectors
    (4 B each), padded one word in 16 keys / 32 ints."""
    key_slots = n_lanes + (n_lanes >> 4)
    int_slots = n_lanes + (n_lanes >> 5)
    return 8 * key_slots + 4 * int_slots * (4 if fused else 1)


def launch_config(n_lanes: int, fused: bool) -> BlockConfig:
    """The block one launch over rows of ``n_lanes`` lanes takes: half a
    thread a lane up to 1024 threads (2-32 lanes a thread), and the row's
    buffers as dynamic shared memory up to :data:`SMEM_MAX_LANES` (K1/K2)
    or :data:`FUSED_SMEM_MAX_LANES` (``fused``), none above (the rows run
    on the L2 scratch).  The launchers pass these to the launch, and the
    kernel contracts declare them."""
    cap = FUSED_SMEM_MAX_LANES if fused else SMEM_MAX_LANES
    return BlockConfig(
        static_smem=STATIC_SMEM,
        dynamic_smem=_row_bytes(n_lanes, fused) if n_lanes <= cap else 0,
        threads=min(n_lanes // 2, MAX_THREADS),
    )


def kernel_attributes(fused: bool, n_lanes: int) -> tuple[int, int]:
    """(static shared memory, max threads a block) of the compiled kernel
    variant that rows of ``n_lanes`` lanes launch; needs the card."""
    fn = _build.library("waterlevel").waterlevel_kernel_attributes
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    static, threads = ctypes.c_int(), ctypes.c_int()
    per = n_lanes // launch_config(n_lanes, fused).threads
    err = fn(int(fused), per, ctypes.byref(static), ctypes.byref(threads))
    if err != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed with CUDA error {err}")
    return static.value, threads.value


def resolve_waterlevel(explicit: str | None, m: int) -> str:
    """The water-level route for a width-``m`` problem: ``"cuda"`` (the
    kernel's wrapper) or ``"torch"`` (the plain pipeline on unpadded
    rows).

    Precedence: explicit > ``set_backend(waterlevel=...)`` scope >
    ``auto``; ``auto`` means the kernel's wrapper, which itself takes the
    plain version only for CPU tensors.  Past :data:`MAX_LANES` the
    route is ``torch`` whatever was asked, as the reference's
    ``resolve_use_pallas`` picks jnp past ``PALLAS_MAX_M``.
    """
    choice = backend.resolve("waterlevel", explicit)
    if m > MAX_LANES or choice == "torch":
        return "torch"
    return "cuda"


def _ceil_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return -(-a // b)


# ---------------------------------------------------------------------------
# kernelcheck geometry contract (verified by repro_torch.analysis.kernelcheck).
#
# The admissible input envelope the int32 range proofs assume, the
# reference's (repro/kernels/waterlevel.py): busy times, μ and demands are
# small integers (paper Sec. V: μ ≤ 4, per-job task counts ≲ 10^4), with
# orders of magnitude of headroom.  WL_SUM_BMU_MAX bounds Σ busy·μ at
# entry; one burst raises it by at most the allocated demand plus one
# level step (Σ μ), so the adapters preserve it up to WL_M_MAX lanes.
# Levels fed back as busy stay ≤ WL_BUSY0_MAX + WL_TOTAL_DEMAND_MAX.

WL_BUSY0_MAX = 1 << 10  # initial (pre-burst) per-server busy time
WL_MU_MAX = 1 << 4  # per-server tasks/slot (μ)
WL_DEMAND_MAX = 1 << 20  # tasks per water-level call (one group)
WL_TOTAL_DEMAND_MAX = 1 << 20  # tasks per job/burst (Σ groups, Σ jobs)
WL_M_MAX = 1 << 16  # widest cluster the torch route is certified for
WL_LEVEL_MAX = WL_BUSY0_MAX + WL_TOTAL_DEMAND_MAX
WL_SUM_BMU_MAX = (1 << 30) + (1 << 22)  # admissible Σ busy·μ at entry


def _wl_dispatch(geom: dict) -> str:
    return resolve_waterlevel(geom["requested"], geom["m"])


def wl_range_claims(m: int) -> list[RangeClaim]:
    """Interval claims shared by the kernels and their plain versions
    (identical int32 arithmetic).  ``m`` only enters through Σ μ; the
    Σ busy·μ prefix is bounded by the declared envelope."""
    busy = Interval(0, WL_LEVEL_MAX)  # evolved levels feed back as busy
    mu = Interval(0, WL_MU_MAX)
    demand = Interval(0, WL_DEMAND_MAX)
    sum_bmu = Interval(0, WL_SUM_BMU_MAX)
    cw = mu * m  # inclusive prefix sum of μ
    xi_num = demand + sum_bmu  # ξ numerator: T + Σ busy·μ
    level = busy + demand + 1  # minimality + the ξ ≥ b+1 clamp
    caps = level * mu  # per-lane capacity at the level
    alloc_prefix = demand + cw  # Σ caps ≤ T + one level step of capacity
    return [
        RangeClaim(
            "sort sentinel headroom (BIG - busy)",
            Interval.const(BIG) - busy,
            positive=True,
        ),
        # the kernel's 64-bit sort key: busy with its sign bit flipped in
        # the high word, the lane in the low word
        RangeClaim("sort key lane field", Interval(0, MAX_LANES - 1), dtype=None, bits=32),
        RangeClaim("cw prefix sum (Σ μ)", cw),
        RangeClaim("cbw prefix sum (Σ busy·μ)", sum_bmu),
        RangeClaim("ξ numerator (T + Σ busy·μ)", xi_num),
        RangeClaim("water level", level),
        RangeClaim("per-lane capacity at level", caps),
        RangeClaim("allocation prefix (Alg. 2 clamp)", alloc_prefix),
    ]


def _wl_smem(geom: dict) -> BlockConfig:
    return launch_config(n_lanes_for(geom["m"]), fused=False)


def _wl_abstract(geom: dict, rows: int = 1):
    lanes = n_lanes_for(geom["m"])
    zeros = torch.zeros((rows, lanes), dtype=torch.int32)
    return waterlevel_sorted, (zeros, zeros.clone(), torch.zeros(rows, dtype=torch.int32))


def waterlevel_sorted_plain(
    b: torch.Tensor, w: torch.Tensor, demand: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, on ``(B, n)`` int32 rows.

    Every intermediate stays int32, so overflow wraps exactly as in the
    reference's jnp path and in the kernel.
    """
    COUNTS["plain"] += 1
    i32 = torch.int32
    order = torch.argsort(b, dim=1, stable=True)
    bs = b.gather(1, order)
    ws = w.gather(1, order)
    cw = torch.cumsum(ws, 1, dtype=i32)
    cbw = torch.cumsum(bs * ws, 1, dtype=i32)
    d = demand.to(i32)[:, None]
    xi = _ceil_div(d + cbw, cw.clamp(min=1))
    next_b = torch.cat([bs[:, 1:], torch.full_like(bs[:, :1], BIG)], 1)
    valid = (xi <= next_b) & (cw > 0)
    first = valid.to(i32).argmax(1, keepdim=True)  # 0 when nothing is valid
    level = torch.maximum(xi.gather(1, first), bs.gather(1, first) + 1)
    caps = (level - bs).clamp(min=0) * ws
    prev = torch.cumsum(caps, 1, dtype=i32) - caps
    take = torch.minimum((d - prev).clamp(min=0), caps)
    return level[:, 0], take, order.to(i32)


def _check(b: torch.Tensor, w: torch.Tensor, demand: torch.Tensor) -> None:
    for name, t, ndim in (("b", b, 2), ("w", w, 2), ("demand", demand, 1)):
        if t.dtype != torch.int32:
            raise TypeError(f"waterlevel: {name} must be int32, got {t.dtype}")
        if t.dim() != ndim:
            raise ValueError(f"waterlevel: {name} must be {ndim}-D, got {t.shape}")
        if not t.is_contiguous():
            raise ValueError(f"waterlevel: {name} must be contiguous")
        if t.device != b.device:
            raise ValueError("waterlevel: b, w and demand must share a device")
    bsz, n = b.shape
    if w.shape != b.shape or demand.shape != (bsz,) or bsz < 1:
        raise ValueError(
            f"waterlevel: shapes b {tuple(b.shape)}, w {tuple(w.shape)}, "
            f"demand {tuple(demand.shape)} do not form (B, n), (B, n), (B,)"
        )
    if n < LANES or n > MAX_LANES or n & (n - 1):
        raise ValueError(
            f"waterlevel: row width {n} must be a power of two in "
            f"[{LANES}, {MAX_LANES}]"
        )


@functools.cache
def _scratch_bytes_fn():
    fn = _build.library("waterlevel").waterlevel_scratch_bytes
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_longlong
    return fn


def _scratch(rows: int, n: int, fused: bool, device: torch.device) -> torch.Tensor | None:
    """The L2 scratch a launch over ``rows`` rows of ``n`` lanes needs
    (None where the rows fit in shared memory), sized by the source."""
    nbytes = _scratch_bytes_fn()(rows, n, int(fused))
    return torch.empty(nbytes, dtype=torch.uint8, device=device) if nbytes else None


@functools.cache
def _launcher():
    fn = _build.library("waterlevel").waterlevel_launch
    ptr = ctypes.c_void_p
    fn.argtypes = [ptr] * 7 + [ctypes.c_int] * 4 + [ptr]
    fn.restype = ctypes.c_int
    return fn


_M_AXIS = span(
    "m",
    1,
    MAX_LANES,
    boundaries=(LANES, FUSED_SMEM_MAX_LANES, SMEM_MAX_LANES, MAX_LANES),
    past=(MAX_LANES + 1, MAX_LANES * 2),
)


@contract(
    "waterlevel.kernel",
    axes=(_M_AXIS, choice("requested", "auto", "torch", "cuda")),
    backends=("cuda", "torch"),
    device_backends=("cuda",),
    dispatch=_wl_dispatch,
    smem=_wl_smem,
    ranges=lambda geom: wl_range_claims(geom["m"]),
    signature=lambda geom: ("waterlevel", n_lanes_for(geom["m"])),
    max_signatures=16,  # pow2 lane classes from 128 to MAX_LANES
    abstract=_wl_abstract,
    eval_points=3,
    notes="K1: one row's water level and takes in one block; rows past "
    "16,384 lanes run on the L2 scratch (no dynamic shared memory), "
    "widths past MAX_LANES take the torch route even when cuda is asked",
)
@contract(
    "waterlevel.kernel-batch",
    axes=(
        span("m", 1, MAX_LANES, boundaries=(LANES, SMEM_MAX_LANES), past=(MAX_LANES + 1,)),
        choice("b", 1, 2, 7, 32, 64),
        choice("requested", "auto", "torch", "cuda"),
    ),
    backends=("cuda", "torch"),
    device_backends=("cuda",),
    dispatch=_wl_dispatch,
    smem=_wl_smem,  # the (B,) grid gives each block one row
    ranges=lambda geom: wl_range_claims(geom["m"]),
    signature=lambda geom: ("waterlevel-batch", n_lanes_for(geom["m"])),
    max_signatures=16,  # pow2 lane classes: B is the grid, not a variant
    abstract=lambda geom: _wl_abstract(geom, geom["b"]),
    eval_points=3,
    notes="K2: the same kernel over a (B,) grid, one block a row; B is "
    "the grid, so the compiled variant is the lane class's",
)
def waterlevel_sorted(
    b: torch.Tensor, w: torch.Tensor, demand: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on ``(B, n)`` rows; CPU tensors take
    :func:`waterlevel_sorted_plain`.  Launches on the current stream and
    does not synchronise."""
    _check(b, w, demand)
    if b.device.type == "cpu":
        return waterlevel_sorted_plain(b, w, demand)
    if b.device.type != "cuda":
        raise ValueError(f"waterlevel: unsupported device {b.device}")
    if b.device.index != torch.cuda.current_device():
        raise ValueError(
            f"waterlevel: tensors on {b.device} but the current device is "
            f"cuda:{torch.cuda.current_device()}"
        )
    bsz, n = b.shape
    level = torch.empty(bsz, dtype=torch.int32, device=b.device)
    take = torch.empty_like(b)
    idx = torch.empty_like(b)
    scratch = _scratch(bsz, n, False, b.device)
    cfg = launch_config(n, False)
    err = _launcher()(
        b.data_ptr(),
        w.data_ptr(),
        demand.data_ptr(),
        level.data_ptr(),
        take.data_ptr(),
        idx.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        bsz,
        n,
        cfg.dynamic_smem,
        cfg.threads,
        torch.cuda.current_stream(b.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"waterlevel kernel launch failed with CUDA error {err} "
            f"(B={bsz}, n_lanes={n})"
        )
    COUNTS["waterlevel" if bsz == 1 else "waterlevel_batch"] += 1
    LAUNCH_CONFIGS["waterlevel", n] = cfg
    return level, take, idx


# ---- the fused water-filling kernel ------------------------------------------

I32 = torch.int32


def _group_step(
    busy: torch.Tensor,
    mu: torch.Tensor,
    mask: torch.Tensor,
    demand: torch.Tensor,
    padded: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One group step over R rows: (R, M) busy / μ, (R, M) mask, (R,)
    demands → (alloc (R, M) in lane order, level (R,)), with the
    ``demand <= 0`` → minimum-available-busy rule.  ``padded`` pads the
    rows to the kernel's lane width first, as the kernel does."""
    b = torch.where(mask, busy, BIG)
    w = torch.where(mask, mu, 0)
    m = b.shape[1]
    if padded:
        pad = n_lanes_for(m) - m
        bp = torch.nn.functional.pad(b, (0, pad), value=BIG)
        wp = torch.nn.functional.pad(w, (0, pad))
    else:
        bp, wp = b, w
    level, take, idx = waterlevel_sorted_plain(bp, wp, demand)
    # idx permutes the padded row (pad lanes carry zero takes): scattering
    # into the padded width and slicing drops them
    alloc = torch.zeros_like(take).scatter_(1, idx.long(), take)[:, :m]
    return alloc, torch.where(demand > 0, level, b.amin(1))


def _phi(levels: torch.Tensor, demands: torch.Tensor) -> torch.Tensor:
    return torch.where(demands > 0, levels, 0).amax(-1)


def wf_groups_plain(
    busy: torch.Tensor,
    mu: torch.Tensor,
    masks: torch.Tensor,
    demands: torch.Tensor,
    *,
    padded: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused kernel's groups mode in plain PyTorch: the K-group scan
    over R independent rows, (R, M) busy / μ, (R, K, M) masks, (R, K)
    demands → (alloc (R, K, M), levels (R, K), Φ (R,)), raising each
    group's servers to its level (eq. 10) before the next group.  Runs on
    any device; ``padded=False`` is the ``torch`` route's unpadded rows."""
    b = busy.to(I32)
    mu = mu.to(I32)
    demands = demands.to(I32)
    allocs, levels = [], []
    for k in range(masks.shape[1]):
        m_k, d_k = masks[:, k], demands[:, k].contiguous()
        alloc_k, xi = _group_step(b, mu, m_k, d_k, padded)
        raised = m_k & (d_k > 0)[:, None]
        b = torch.where(raised, torch.maximum(b, xi[:, None]), b)  # eq. 10
        allocs.append(alloc_k)
        levels.append(xi)
    levels_t = torch.stack(levels, 1)
    return torch.stack(allocs, 1), levels_t, _phi(levels_t, demands)


def wf_chain_plain(
    busy: torch.Tensor,
    mu: torch.Tensor,
    masks: torch.Tensor,
    demands: torch.Tensor,
    *,
    padded: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused kernel's chain mode in plain PyTorch: B jobs admitted in
    series from the (M,) busy vector, eq. 2 committed between jobs; (B,
    M) μ, (B, K, M) masks, (B, K) demands → (alloc (B, K, M), levels (B,
    K), Φ (B,), busy after the burst (M,))."""
    b = busy.to(I32)[None]
    mu = mu.to(I32)
    demands = demands.to(I32)
    allocs, levels, phis = [], [], []
    for j in range(mu.shape[0]):
        alloc_j, levels_j, phi_j = wf_groups_plain(
            b, mu[j : j + 1], masks[j : j + 1], demands[j : j + 1], padded=padded
        )
        loads = alloc_j[0].sum(0, dtype=I32)
        # loads > 0 only where μ > 0; the clamp keeps the other lanes'
        # (discarded) division defined
        mu_j = mu[j].clamp(min=1)
        b = b + torch.where(loads > 0, -(-loads // mu_j), 0)  # eq. 2
        allocs.append(alloc_j[0])
        levels.append(levels_j[0])
        phis.append(phi_j[0])
    return torch.stack(allocs), torch.stack(levels), torch.stack(phis), b[0]


def _check_fused(
    name: str,
    busy: torch.Tensor,
    mu: torch.Tensor,
    masks: torch.Tensor,
    demands: torch.Tensor,
    busy_ndim: int,
) -> tuple[int, int, int]:
    """Refuses what the fused kernel does not take; returns (P, K, M)."""
    for arg, t, ndim, dtype in (
        ("busy", busy, busy_ndim, torch.int32),
        ("mu", mu, 2, torch.int32),
        ("masks", masks, 3, torch.bool),
        ("demands", demands, 2, torch.int32),
    ):
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} must be {dtype}, got {t.dtype}")
        if t.dim() != ndim:
            raise ValueError(f"{name}: {arg} must be {ndim}-D, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if t.device != busy.device:
            raise ValueError(f"{name}: busy, mu, masks and demands must share a device")
    p, k, m = masks.shape
    want_busy = (m,) if busy_ndim == 1 else (p, m)
    if (
        tuple(busy.shape) != want_busy
        or tuple(mu.shape) != (p, m)
        or tuple(demands.shape) != (p, k)
        or p < 1
        or k < 1
        or m < 1
    ):
        raise ValueError(
            f"{name}: shapes busy {tuple(busy.shape)}, mu {tuple(mu.shape)}, masks "
            f"{tuple(masks.shape)}, demands {tuple(demands.shape)} do not form "
            f"{'(M,)' if busy_ndim == 1 else '(P, M)'}, (P, M), (P, K, M), (P, K) "
            f"with P, K, M >= 1"
        )
    if m > MAX_LANES:
        raise ValueError(f"{name}: {m} servers past the kernel's {MAX_LANES} lanes")
    if busy.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {busy.device}")
    if busy.device.type == "cuda" and busy.device.index != torch.cuda.current_device():
        raise ValueError(
            f"{name}: tensors on {busy.device} but the current device is "
            f"cuda:{torch.cuda.current_device()}"
        )
    return p, k, m


@functools.cache
def _fused_launcher():
    fn = _build.library("waterlevel").wf_fused_launch
    ptr = ctypes.c_void_p
    fn.argtypes = [ptr] * 9 + [ctypes.c_int] * 8 + [ptr]
    fn.restype = ctypes.c_int
    return fn


def _launch_fused(busy, mu, masks, demands, chain: bool):
    p, k, m = masks.shape
    dev = busy.device
    n = n_lanes_for(m)
    rows = 1 if chain else p
    alloc = torch.empty((p, k, m), dtype=I32, device=dev)
    levels = torch.empty((p, k), dtype=I32, device=dev)
    phi = torch.empty(p, dtype=I32, device=dev)
    busy_out = torch.empty(m, dtype=I32, device=dev) if chain else None
    scratch = _scratch(rows, n, True, dev)
    cfg = launch_config(n, True)
    err = _fused_launcher()(
        busy.data_ptr(),
        mu.data_ptr(),
        masks.data_ptr(),
        demands.data_ptr(),
        alloc.data_ptr(),
        levels.data_ptr(),
        phi.data_ptr(),
        None if busy_out is None else busy_out.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        rows,
        p if chain else 1,
        k,
        m,
        n,
        int(chain),
        cfg.dynamic_smem,
        cfg.threads,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"fused water-filling kernel launch failed with CUDA error {err} "
            f"(P={p}, K={k}, M={m}, chain={chain})"
        )
    COUNTS["wf_chain" if chain else "wf_groups"] += 1
    COUNTS["wf_group_steps"] += p * k
    LAUNCH_CONFIGS["wf_fused", n] = cfg
    return alloc, levels, phi, busy_out


def wf_groups(
    busy: torch.Tensor, mu: torch.Tensor, masks: torch.Tensor, demands: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The K-group scan over R independent rows in one launch (one block a
    row): int32 (R, M) busy / μ, bool (R, K, M) masks, int32 (R, K)
    demands, all contiguous → (alloc (R, K, M), levels (R, K), Φ (R,)).
    CPU tensors take :func:`wf_groups_plain`.  Launches on the current
    stream and does not synchronise."""
    _check_fused("wf_groups", busy, mu, masks, demands, 2)
    if busy.device.type == "cpu":
        return wf_groups_plain(busy, mu, masks, demands)
    alloc, levels, phi, _ = _launch_fused(busy, mu, masks, demands, chain=False)
    return alloc, levels, phi


def wf_chain(
    busy: torch.Tensor, mu: torch.Tensor, masks: torch.Tensor, demands: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """B jobs admitted in series in one launch (one block): int32 (M,)
    busy, (B, M) μ, bool (B, K, M) masks, int32 (B, K) demands, all
    contiguous → (alloc (B, K, M), levels (B, K), Φ (B,), busy after the
    burst (M,)).  CPU tensors take :func:`wf_chain_plain`.  Launches on
    the current stream and does not synchronise."""
    _check_fused("wf_chain", busy, mu, masks, demands, 1)
    if busy.device.type == "cpu":
        return wf_chain_plain(busy, mu, masks, demands)
    return _launch_fused(busy, mu, masks, demands, chain=True)
