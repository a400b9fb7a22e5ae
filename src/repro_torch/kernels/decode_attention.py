"""The decode-attention kernel's wrapper, its plain PyTorch version, and counts.

Counterpart of ``repro/kernels/decode_attention.py``.  The TPU kernel
``_decode_kernel`` (launched by ``decode_attention_pallas`` on a
``(batch, q_heads)`` grid over 512-row KV slices) is
``csrc/decode_attention.cu`` here: one block per (sequence, KV head)
serving the group's query heads, any cache length, built from source at
first use (:mod:`._build`).

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
    "NEG_INF",
    "decode_attention",
    "decode_attention_plain",
    "reset_counts",
]

NEG_INF = -1e30
MAX_HEAD_DIM = 128  # the kernel's per-warp accumulators hold one head row
MAX_GROUP = 8  # query heads per KV head one block serves

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


def _lane_width(hd: int) -> int:
    """Elements of a head row each lane loads at once (the kernel's EPL)."""
    return 1 if hd <= 32 else 2 if hd <= 64 else 4


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
    fn.argtypes = [ptr] * 5 + [i32] * 5 + [ctypes.c_float, i32, ptr]
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
    if hd > MAX_HEAD_DIM or hd % _lane_width(hd) or h // hkv > MAX_GROUP:
        raise ValueError(
            f"decode_attention: the kernel takes hd <= {MAX_HEAD_DIM} (a multiple "
            f"of {_lane_width(hd)}) and <= {MAX_GROUP} query heads per KV head; "
            f"got hd={hd}, group={h // hkv}"
        )
    if not all(x.is_contiguous() for x in (q, k, v, pos)):
        raise ValueError("decode_attention: q, k, v and pos must be contiguous")
    align = _lane_width(hd) * q.element_size()
    if any(x.data_ptr() % align for x in (q, k, v)):
        raise ValueError(f"decode_attention: q, k and v must be {align}-byte aligned")
    out = torch.empty_like(q)
    err = _launcher()(
        q.data_ptr(),
        k.data_ptr(),
        v.data_ptr(),
        pos.data_ptr(),
        out.data_ptr(),
        b,
        h,
        hkv,
        t,
        hd,
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
