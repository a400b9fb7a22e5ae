"""The decode-attention kernel's wrapper, its plain PyTorch version, and counts.

Counterpart of ``repro/kernels/decode_attention.py``.  The TPU kernel
``_decode_kernel`` (launched by ``decode_attention_pallas`` on a
``(batch, q_heads)`` grid over 512-row KV slices) is
``csrc/decode_attention.cu`` here, built from source at first use
(:mod:`._build`): the cache is split over a grid of ``(splits, Hkv *
slices, B)`` blocks (:func:`split_plan`, from the shapes alone), each
serving a slice of at most 8 of the group's query heads over its 64-key
chunks (:func:`group_slices`: one slice up to a group of 8, two at
Qwen3-MoE's 16, ``ceil(G / 8)`` at any group), and the last block of each
(sequence, KV head, slice) to finish merges the blocks' partial softmax
states in the same launch.  Every head width from 1 to 256 launches
(:func:`lane_plan`); past 256 a CUDA tensor is refused, since no decoder
the repository configures has a wider head.

Both functions take ``q`` ``(B, H, hd)`` (one token per sequence),
``k``/``v`` ``(B, Hkv, T, hd)`` — the port's KV-cache layout — and
``pos`` ``(B,)`` int32, the last valid cache index per sequence, and
return ``(B, H, hd)``: softmax(q·kᵀ / sqrt(hd)) · v over the keys
``t <= pos``, with fp32 math and the result in ``q``'s dtype.  Query
head ``h`` reads KV head ``h // (H // Hkv)``.

- :func:`decode_attention` launches the kernel for a CUDA tensor, or
  raises; it takes the plain version only for a tensor on the CPU.
- :func:`decode_attention_plain` is the same function in plain PyTorch
  (the port's copy of ``repro/kernels/ref.py::decode_attention_ref``).
  For ``pos < 0`` (no valid key, which no caller passes) the two differ:
  the plain version averages every value row, the kernel returns 0, as
  the TPU kernel does.

The kernel's merge finds the last block of a (sequence, KV head, slice)
by a ticket counter that this module keeps per device and the kernel resets
to 0; launches that share the counters run one at a time (one stream).

``COUNTS`` holds plain integers: ``decode_attention`` counts kernel
launches, ``plain`` counts calls of the plain version.
:func:`reset_counts` zeroes them.

The dry run's rules (:mod:`._tensors`, inside its ``counting`` scope):
``meta`` inputs get :func:`decode_attention`'s shape rule (``out`` like
``q`` and the fp32 partials the launch allocates, planned for an
H100's SMs), after the launch's checks, and every call adds
:func:`op_count` and :func:`byte_count`.  Both read shapes only: a count
cannot read ``pos``, which lies on the device, so they take every one of
the T cache rows, and where the kernel stops at ``pos + 1`` they are
upper bounds.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..analysis.contracts import BlockConfig, choice, contract, span
from . import _build
from ._tensors import H100_SMS, active, check_device, check_dtype, count, uncounted

__all__ = [
    "COUNTS",
    "MAX_HEAD_DIM",
    "MAX_SLICE",
    "NEG_INF",
    "byte_count",
    "decode_attention",
    "decode_attention_plain",
    "group_slices",
    "lane_plan",
    "lane_width",
    "op_count",
    "reset_counts",
    "split_plan",
]

NEG_INF = -1e30
MAX_HEAD_DIM = 256  # the widest head row the kernel takes (csrc kMaxHeadDim)
ONE_LOAD_HEAD_DIM = 128  # the widest row a lane loads once (csrc kOneLoadHeadDim)
MAX_LANE_ELEMS = 8  # elements of one head row a lane holds (csrc kMaxLaneElems)
MAX_SLICE = 8  # query heads per KV head one block serves (csrc kMaxSlice)
CHUNK = 64  # keys a block takes at a time: one load of K and V per lane
MAX_SPLITS = 64  # blocks per (sequence, KV head): the length of the merge's loop
BLOCKS_PER_SM = 4  # the kernel's residency at <= 128 registers a thread
VEC_BYTES = 16  # the widest load of a head row's slice per lane
THREADS = 128  # the kernel's block: 4 warps

_TICKETS: dict[int, torch.Tensor] = {}  # device index -> int32 counters, all 0

COUNTS = {"decode_attention": 0, "plain": 0}


def reset_counts() -> None:
    for key in COUNTS:
        COUNTS[key] = 0


def decode_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos: torch.Tensor
) -> torch.Tensor:
    """The kernel's function in plain PyTorch."""
    COUNTS["plain"] += 1
    b, h, hd = q.shape
    hkv, t = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, hkv, h // hkv, hd)
    logits = torch.einsum("bngh,bnth->bngt", qg, k.float()) * hd**-0.5
    valid = torch.arange(t, device=q.device)[None, :] <= pos[:, None]
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bngt,bnth->bngh", p, v.float())
    return out.reshape(b, h, hd).to(q.dtype)


def group_slices(group: int) -> tuple[int, int]:
    """``(n_slices, slice_heads)``: a group of ``group`` query heads per KV
    head cut into ``ceil(group / 8)`` slices of ``ceil(group / n_slices)``
    heads (the last may hold fewer), one block's share each; the kernel
    cuts it by the same rule, at any group.  Refuses a group below 1."""
    if group < 1:
        raise ValueError(
            f"decode_attention: a group needs at least 1 query head per KV head; got {group}"
        )
    n_slices = -(-group // MAX_SLICE)
    return n_slices, -(-group // n_slices)


def split_plan(b: int, hkv: int, t: int, sms: int, group: int = 1) -> tuple[int, int]:
    """``(chunk, splits)`` for B sequences of Hkv KV heads (each serving
    ``group`` query heads) over a cache of ``t`` positions on a card of
    ``sms`` SMs: chunks of ``chunk`` keys, dealt round-robin to
    ``splits`` blocks per (sequence, KV head, slice of the group).  As
    many splits as the grid can hold resident at once (4 blocks per SM),
    at most one per chunk and 64 in all; at least one.  So a 4 x 20-head
    serving batch runs 6 splits (480 blocks on 132 SMs) at any cache
    length, and Qwen3-MoE's 4 x 4 KV heads of 16 query heads (two slices)
    16 splits over 1024 positions.  It reads shapes only, never ``pos``,
    which lies on the device."""
    chunks = -(-t // CHUNK)
    blocks = b * hkv * group_slices(group)[0]
    return CHUNK, max(1, min(chunks, MAX_SPLITS, BLOCKS_PER_SM * sms // blocks))


def _partial_rows(b: int, h: int, hkv: int, t: int, sms: int) -> int:
    """Rows of hd + 2 fp32 the launch's partials hold: one per (sequence,
    KV head, slice, split, head of the slice)."""
    n_slices, slice_heads = group_slices(h // hkv)
    return b * hkv * n_slices * split_plan(b, hkv, t, sms, h // hkv)[1] * slice_heads


def op_count(b: int, h: int, hkv: int, t: int, hd: int) -> int:
    """Operations of one call: q . k and p . v over all ``t`` cache rows
    for each of the B x H query heads, ``4 * B * H * T * hd``.  An upper
    bound: the kernel reads the keys up to ``pos`` only."""
    return 4 * b * h * t * hd


def byte_count(b: int, h: int, hkv: int, t: int, hd: int, itemsize: int,
               sms: int = H100_SMS) -> int:
    """Device-memory bytes of one call: q, ``pos`` and the output once, the
    K and V rows of all ``t`` positions once per slice of the group (an
    upper bound, as :func:`op_count`), and the fp32 partials written by
    the splits and read by the merge."""
    n_slices = group_slices(h // hkv)[0]
    qo = 2 * b * h * hd * itemsize
    kv = 2 * b * hkv * t * hd * itemsize * n_slices
    part = 2 * _partial_rows(b, h, hkv, t, sms) * (hd + 2) * 4
    return qo + kv + part + 4 * b


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def lane_plan(hd: int, itemsize: int) -> tuple[int, int] | None:
    """``(epl, nv)``: a lane loads ``epl`` contiguous elements of a head row
    at once, ``nv`` times.  The widest load of at most 16 bytes that
    divides ``hd``; one load a lane (``nv`` 1, the row on the fewest of 32
    lanes) where the row fits and ``hd`` <= 128; else the row on all 32
    lanes, ``nv`` the power of two that covers it (at least 2 past 128),
    with at most 8 elements a lane (``epl * nv``).  So hd 128 in bf16 is
    (8, 1), hd 33 (1, 2), hd 256 (4, 2) in either dtype.  None past
    ``MAX_HEAD_DIM`` (256)."""
    if not 1 <= hd <= MAX_HEAD_DIM:
        return None
    for nbytes in (VEC_BYTES, VEC_BYTES // 2, VEC_BYTES // 4, VEC_BYTES // 8):
        epl = nbytes // itemsize
        if epl < 1 or hd % epl:
            continue
        if hd <= 32 * epl and hd <= ONE_LOAD_HEAD_DIM:
            return epl, 1
        nv = 1 << (-(-hd // (32 * epl)) - 1).bit_length()
        if hd > ONE_LOAD_HEAD_DIM:
            nv = max(nv, 2)
        if epl * nv <= MAX_LANE_ELEMS:
            return epl, nv
    return None


def lane_width(hd: int, itemsize: int) -> int | None:
    """Elements of a head row each lane loads at once (:func:`lane_plan`'s
    ``epl``); None past 256."""
    plan = lane_plan(hd, itemsize)
    return None if plan is None else plan[0]


def _tickets(device: torch.device, n: int) -> torch.Tensor:
    buf = _TICKETS.get(device.index)
    if buf is None or buf.numel() < n:
        buf = _TICKETS[device.index] = torch.zeros(
            max(n, 1024), dtype=torch.int32, device=device
        )
    return buf


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos: torch.Tensor) -> None:
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"decode_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} do not form (B, H, hd), (B, Hkv, T, hd) x 2"
        )
    b, h, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or k.shape[1] < 1 or h % k.shape[1]:
        raise ValueError(
            f"decode_attention: q {tuple(q.shape)} and k {tuple(k.shape)} "
            f"disagree on batch or head dim, or H is not a multiple of Hkv"
        )
    if pos.shape != (b,) or pos.dtype != torch.int32:
        raise ValueError(
            f"decode_attention: pos must be int32 of shape ({b},), got "
            f"{pos.dtype} {tuple(pos.shape)}"
        )


@functools.cache
def _launcher():
    fn = _build.library("decode_attention").decode_attention_launch
    ptr = ctypes.c_void_p
    i32 = ctypes.c_int
    fn.argtypes = [ptr] * 7 + [i32] * 9 + [ctypes.c_float, i32, ptr]
    fn.restype = ctypes.c_int
    return fn


def _instance_heads(group: int, nv: int) -> int:
    """NG: the query heads the compiled instance holds a slice of (8 where
    a lane loads its row more than once)."""
    width = group_slices(group)[1] if nv == 1 else MAX_SLICE
    return next(ng for ng in (1, 2, 4, MAX_SLICE) if width <= ng)


def _itemsize(geom: dict) -> int:
    return 4 if geom["dtype"] == "float32" else 2


def _k5_dispatch(geom: dict) -> str:
    if geom["device"] == "cpu":
        return "plain"
    return "refused" if lane_plan(geom["hd"], _itemsize(geom)) is None else "cuda"


def _k5_smem(geom: dict) -> BlockConfig:
    """The instance's static shared memory: the warps' (m, l) and their
    accumulator rows (128 wide for one load a lane, else 256), and the
    merge flag."""
    _, nv = lane_plan(geom["hd"], _itemsize(geom))
    ng = _instance_heads(geom["group"], nv)
    row = ONE_LOAD_HEAD_DIM if nv == 1 else MAX_HEAD_DIM
    warps = THREADS // 32
    return BlockConfig(static_smem=4 * warps * ng * (2 + row) + 4, dynamic_smem=0,
                       threads=THREADS)


def _k5_abstract(geom: dict):
    dt = getattr(torch, geom["dtype"])
    g, hd = geom["group"], geom["hd"]
    q = torch.zeros(1, g, hd, dtype=dt)
    kv = torch.zeros(1, 1, 8, hd, dtype=dt)
    return decode_attention, (q, kv, kv, torch.tensor([3], dtype=torch.int32))


@contract(
    "decode_attention.kernel",
    axes=(
        span("hd", 1, MAX_HEAD_DIM, boundaries=(32, 64, ONE_LOAD_HEAD_DIM, MAX_HEAD_DIM),
             past=(MAX_HEAD_DIM + 1, 2 * MAX_HEAD_DIM)),
        choice("group", 1, 2, 4, 8, 9, 16, 17, 32, 64),
        choice("dtype", "float32", "bfloat16"),
        choice("device", "cuda", "cpu"),
    ),
    backends=("cuda", "plain", "refused"),
    device_backends=("cuda",),
    dispatch=_k5_dispatch,
    smem=_k5_smem,
    # the compiled instance (NG, EPL, NV) and hd, which the launch takes
    # at run time: at most 2 dtypes x 4 slice widths x 256 widths
    signature=lambda geom: ("decode_attention", geom["dtype"],
                            _instance_heads(geom["group"],
                                            lane_plan(geom["hd"], _itemsize(geom))[1]),
                            *lane_plan(geom["hd"], _itemsize(geom)), geom["hd"]),
    max_signatures=2 * 4 * MAX_HEAD_DIM,
    abstract=_k5_abstract,
    notes="K5: every group (ceil(G / 8) slices) and every hd from 1 to 256 "
    "launch; past 256 a CUDA tensor is refused, a CPU tensor takes the plain "
    "version",
)
def decode_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos: torch.Tensor
) -> torch.Tensor:
    """Launch the CUDA kernel; CPU tensors take :func:`decode_attention_plain`.
    Launches on the current stream and does not synchronise."""
    _check(q, k, v, pos)
    code = check_dtype("decode_attention", q, k, v)
    dev = check_device("decode_attention", q, k, v, pos)
    b, h, hd = q.shape
    hkv, t = k.shape[1], k.shape[2]
    if dev == "cpu":
        if not active():
            return decode_attention_plain(q, k, v, pos)
        # the launch's output and partials, in the counters' sight
        out = torch.empty_like(q)
        part = torch.empty(_partial_rows(b, h, hkv, t, H100_SMS) * (hd + 2),
                           dtype=torch.float32)
        with uncounted():
            out.copy_(decode_attention_plain(q, k, v, pos))
        del part
        _count(b, h, hkv, t, hd, q.element_size())
        return out
    plan = lane_plan(hd, q.element_size())
    if plan is None:
        raise ValueError(
            f"decode_attention: the kernel takes hd from 1 to {MAX_HEAD_DIM}; got hd={hd}"
        )
    epl, nv = plan
    n_slices, slice_heads = group_slices(h // hkv)
    if not all(x.is_contiguous() for x in (q, k, v, pos)):
        raise ValueError("decode_attention: q, k, v and pos must be contiguous")
    align = epl * q.element_size()
    if any(x.data_ptr() % align for x in (q, k, v)):
        raise ValueError(f"decode_attention: q, k and v must be {align}-byte aligned")
    sms = H100_SMS if dev == "meta" else _sms(q.device.index)
    chunk, splits = split_plan(b, hkv, t, sms, h // hkv)
    out = torch.empty_like(q)
    rows = b * hkv * n_slices * splits * slice_heads  # partial rows of hd + 2
    part = torch.empty(rows * (hd + 2), dtype=torch.float32, device=q.device)
    if dev == "meta":
        _count(b, h, hkv, t, hd, q.element_size())
        return out
    err = _launcher()(
        q.data_ptr(),
        k.data_ptr(),
        v.data_ptr(),
        pos.data_ptr(),
        out.data_ptr(),
        part.data_ptr(),
        _tickets(q.device, b * hkv * n_slices).data_ptr(),
        b,
        h,
        hkv,
        t,
        hd,
        chunk,
        splits,
        epl,
        nv,
        float(hd**-0.5),
        code,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"decode_attention kernel launch failed with CUDA error {err} "
            f"(B={b}, H={h}, Hkv={hkv}, T={t}, hd={hd}, dtype={q.dtype})"
        )
    COUNTS["decode_attention"] += 1
    if active():
        _count(b, h, hkv, t, hd, q.element_size())
    return out


def _count(b: int, h: int, hkv: int, t: int, hd: int, itemsize: int) -> None:
    count("decode_attention", op_count(b, h, hkv, t, hd),
          byte_count(b, h, hkv, t, hd, itemsize))
