"""The decode-attention kernel's wrapper, its plain PyTorch version, and counts.

Counterpart of ``repro/kernels/decode_attention.py``.  The TPU kernel
``_decode_kernel`` (launched by ``decode_attention_pallas`` on a
``(batch, q_heads)`` grid over 512-row KV slices) is
``csrc/decode_attention.cu`` here, built from source at first use
(:mod:`._build`): the cache is split over a grid of ``(splits, Hkv *
slices, B)`` blocks (:func:`split_plan`, from the shapes alone), each
serving a slice of at most 8 of the group's query heads over its 64-key
chunks (:func:`group_slices`: one slice up to a group of 8, two at
Qwen3-MoE's 16), and the last block of each (sequence, KV head, slice)
to finish merges the blocks' partial softmax states in the same launch.

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
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from ._tensors import check_device, check_dtype

__all__ = [
    "COUNTS",
    "MAX_GROUP",
    "MAX_HEAD_DIM",
    "MAX_SLICE",
    "NEG_INF",
    "decode_attention",
    "decode_attention_plain",
    "group_slices",
    "lane_width",
    "reset_counts",
    "split_plan",
]

NEG_INF = -1e30
MAX_HEAD_DIM = 128  # the kernel's per-lane accumulators hold one head row
MAX_GROUP = 16  # query heads per KV head the kernel takes (csrc kMaxGroup)
MAX_SLICE = 8  # query heads per KV head one block serves (csrc kMaxSlice)
CHUNK = 64  # keys a block takes at a time: one load of K and V per lane
MAX_SPLITS = 64  # blocks per (sequence, KV head): the length of the merge's loop
BLOCKS_PER_SM = 4  # the kernel's residency at <= 128 registers a thread
VEC_BYTES = 16  # the widest load of a head row's slice per lane

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
    cuts it by the same rule.  Refuses a group past ``MAX_GROUP``."""
    if not 1 <= group <= MAX_GROUP:
        raise ValueError(
            f"decode_attention: the kernel takes 1 to {MAX_GROUP} query heads per KV "
            f"head; got {group}"
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


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def lane_width(hd: int, itemsize: int) -> int | None:
    """Elements of a head row each lane loads at once: the widest load of
    at most 16 bytes that divides ``hd`` with the row on at most 32 lanes;
    None where there is none (``hd`` past 128, or odd past 32)."""
    for nbytes in (VEC_BYTES, VEC_BYTES // 2, VEC_BYTES // 4, VEC_BYTES // 8):
        epl = nbytes // itemsize
        if epl >= 1 and hd % epl == 0 and hd <= 32 * epl and hd <= MAX_HEAD_DIM:
            return epl
    return None


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
    fn.argtypes = [ptr] * 7 + [i32] * 8 + [ctypes.c_float, i32, ptr]
    fn.restype = ctypes.c_int
    return fn


def decode_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos: torch.Tensor
) -> torch.Tensor:
    """Launch the CUDA kernel; CPU tensors take :func:`decode_attention_plain`.
    Launches on the current stream and does not synchronise."""
    _check(q, k, v, pos)
    code = check_dtype("decode_attention", q, k, v)
    if check_device("decode_attention", q, k, v, pos) == "cpu":
        return decode_attention_plain(q, k, v, pos)
    b, h, hd = q.shape
    hkv, t = k.shape[1], k.shape[2]
    epl = lane_width(hd, q.element_size())
    if epl is None:
        raise ValueError(
            f"decode_attention: the kernel takes hd <= {MAX_HEAD_DIM} (odd only up to 32); "
            f"got hd={hd}"
        )
    n_slices, slice_heads = group_slices(h // hkv)
    if not all(x.is_contiguous() for x in (q, k, v, pos)):
        raise ValueError("decode_attention: q, k, v and pos must be contiguous")
    align = epl * q.element_size()
    if any(x.data_ptr() % align for x in (q, k, v)):
        raise ValueError(f"decode_attention: q, k and v must be {align}-byte aligned")
    chunk, splits = split_plan(b, hkv, t, _sms(q.device.index), h // hkv)
    out = torch.empty_like(q)
    rows = b * hkv * n_slices * splits * slice_heads  # partial rows of hd + 2
    part = torch.empty(rows * (hd + 2), dtype=torch.float32, device=q.device)
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
    return out
