"""The flash-attention kernel's wrapper, its plain PyTorch version, and counts.

Counterpart of ``repro/kernels/flash_attention.py``.  The TPU kernel
``_flash_kernel`` (launched by ``flash_attention_pallas`` on a
``(batch, q_heads, S / 128)`` grid) is ``csrc/flash_attention.cu`` here:
64-row query and KV tiles, online softmax in fp32, KV tiles above the
causal diagonal skipped, any S and T, built from source at first use
(:mod:`._build`).

Both functions take ``q`` ``(B, H, S, hd)`` and ``k``/``v``
``(B, Hkv, T, hd)`` and return ``(B, H, S, hd)``: softmax(q·kᵀ /
sqrt(hd)) · v, causal (row ``i`` sees columns ``j <= i``) or not, with
fp32 math and the result in ``q``'s dtype.  Query head ``h`` reads KV
head ``h // (H // Hkv)``.  The kernel reads its inputs through their
strides (only the head dim need be contiguous), so the model hands it
transposed views of its ``(B, S, H, hd)`` projections without a copy;
the output is allocated with ``q``'s strides.

- :func:`flash_attention` launches the kernel for a CUDA tensor, or
  raises; it takes the plain version only for a tensor on the CPU.
- :func:`flash_attention_plain` is the same function in plain PyTorch
  (the port's copy of ``repro/kernels/ref.py::flash_attention_ref``).

``COUNTS`` holds plain integers: ``flash_attention`` counts kernel
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
    "HEAD_DIMS",
    "NEG_INF",
    "flash_attention",
    "flash_attention_plain",
    "reset_counts",
]

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 80, 128)  # the kernel's compiled head widths

COUNTS = {"flash_attention": 0, "plain": 0}


def reset_counts() -> None:
    for key in COUNTS:
        COUNTS[key] = 0


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True
) -> torch.Tensor:
    """The kernel's function in plain PyTorch."""
    COUNTS["plain"] += 1
    b, h, s, hd = q.shape
    hkv, t = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, hkv, h // hkv, s, hd)
    logits = torch.einsum("bngsh,bnth->bngst", qg, k.float()) * hd**-0.5
    if causal:
        mask = (
            torch.arange(s, device=q.device)[:, None]
            >= torch.arange(t, device=q.device)[None, :]
        )
        logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bngst,bnth->bngsh", p, v.float())
    return out.reshape(b, h, s, hd).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"flash_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} do not form (B, H, S, hd), (B, Hkv, T, hd) x 2"
        )
    b, h, s, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or k.shape[1] < 1 or h % k.shape[1]:
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)} and k {tuple(k.shape)} "
            f"disagree on batch or head dim, or H is not a multiple of Hkv"
        )
    if s < 1 or k.shape[2] < 1:
        raise ValueError("flash_attention: empty sequence")


@functools.cache
def _launcher():
    fn = _build.library("flash_attention").flash_attention_launch
    ptr = ctypes.c_void_p
    i32 = ctypes.c_int
    i64 = ctypes.c_longlong
    fn.argtypes = [ptr] * 4 + [i32] * 6 + [i64] * 12 + [i32, ctypes.c_float, i32, ptr]
    fn.restype = ctypes.c_int
    return fn


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True
) -> torch.Tensor:
    """Launch the CUDA kernel; CPU tensors take :func:`flash_attention_plain`.
    Launches on the current stream and does not synchronise."""
    _check(q, k, v)
    code = check_dtype("flash_attention", q, k, v)
    if check_device("flash_attention", q, k, v) == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    b, h, s, hd = q.shape
    hkv, t = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the kernel takes hd in {HEAD_DIMS}, got {hd}")
    if any(x.stride(3) != 1 for x in (q, k, v)):
        raise ValueError("flash_attention: the head dim of q, k and v must be contiguous")
    out = torch.empty_like(q)  # q's strides where q is dense, else contiguous
    err = _launcher()(
        q.data_ptr(),
        k.data_ptr(),
        v.data_ptr(),
        out.data_ptr(),
        b,
        h,
        hkv,
        s,
        t,
        hd,
        *q.stride()[:3],
        *k.stride()[:3],
        *v.stride()[:3],
        *out.stride()[:3],
        int(causal),
        float(hd**-0.5),
        code,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed with CUDA error {err} "
            f"(B={b}, H={h}, Hkv={hkv}, S={s}, T={t}, hd={hd}, dtype={q.dtype})"
        )
    COUNTS["flash_attention"] += 1
    return out
