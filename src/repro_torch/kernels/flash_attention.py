"""The flash-attention kernel's wrapper, its plain PyTorch version, and counts.

Counterpart of ``repro/kernels/flash_attention.py``.  The TPU kernel
``_flash_kernel`` (launched by ``flash_attention_pallas`` on a
``(batch, q_heads, S / 128)`` grid) is ``csrc/flash_attention.cu`` here,
built from source at first use (:mod:`._build`), in two kernels chosen by
dtype before the launch (:func:`route`):

- bfloat16 takes the tensor cores: 128-row query blocks, K/V tiles of
  128 keys copied by TMA into a three-stage ring, both products on
  ``wgmma`` with fp32 accumulators and the online softmax in fp32;
- float32 takes the CUDA cores (64-row tiles staged in shared memory, all
  in fp32), since TF32 tensor cores would not hold the float32 model
  paths to their tolerance.

Both functions take ``q`` ``(B, H, S, hd)`` and ``k``/``v``
``(B, Hkv, T, hd)`` and return ``(B, H, S, hd)``: softmax(q·kᵀ /
sqrt(hd)) · v, causal (row ``i`` sees columns ``j <= i``) or not, with
fp32 math and the result in ``q``'s dtype.  Query head ``h`` reads KV
head ``h // (H // Hkv)``.  The kernels read their inputs through their
strides (only the head dim need be contiguous), so the model hands them
transposed views of its ``(B, S, H, hd)`` projections without a copy;
the output is allocated with ``q``'s strides.  The bfloat16 kernel's
copies are TMA's, which need 16-byte aligned inputs and strides
(:func:`tma_strides`); a tensor that breaks that is refused, never
copied.

- :func:`flash_attention` launches a kernel for a CUDA tensor, or
  raises; it takes the plain version only for a tensor on the CPU.
- :func:`flash_attention_plain` is the same function in plain PyTorch
  (the port's copy of ``repro/kernels/ref.py::flash_attention_ref``).

``COUNTS`` holds plain integers: ``flash_attention`` counts kernel
launches, ``tensor_core`` the bfloat16 ones among them, ``plain`` calls
of the plain version.  :func:`reset_counts` zeroes them.
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
    "route",
    "tma_strides",
]

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 80, 128)  # the kernels' compiled head widths
TMA_BYTES = 16  # TMA's alignment of a tensor's base address and strides
_ENTRY = {  # the C entry point of each route
    "tensor_core": "flash_attention_bf16_launch",
    "cuda_core": "flash_attention_f32_launch",
}

COUNTS = {"flash_attention": 0, "tensor_core": 0, "plain": 0}


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


def route(dtype: torch.dtype) -> str:
    """The kernel a CUDA tensor of ``dtype`` takes: ``"tensor_core"`` for
    bfloat16, ``"cuda_core"`` for float32."""
    if dtype == torch.bfloat16:
        return "tensor_core"
    if dtype == torch.float32:
        return "cuda_core"
    raise TypeError(f"flash_attention: no kernel for {dtype}")


def tma_strides(name: str, x: torch.Tensor) -> tuple[int, int, int]:
    """The (batch, head, row) strides in elements that the bfloat16
    kernel's tensor map gets for ``x``; raises ``ValueError`` where TMA
    cannot read ``x`` as it lies: a base address or a stride (of a
    dimension longer than 1) that is not a multiple of 16 bytes, or a
    head dim that is not contiguous.  A dimension of length 1 gets the
    dense stride (its own is never stepped over)."""
    elt = x.element_size()
    if x.stride(3) != 1:
        raise ValueError(f"flash_attention: the head dim of {name} must be contiguous")
    if x.data_ptr() % TMA_BYTES:
        raise ValueError(
            f"flash_attention: {name} must be {TMA_BYTES}-byte aligned for TMA, "
            f"its address is {x.data_ptr() % TMA_BYTES} bytes past"
        )
    b, h, s, hd = x.shape
    dense = (h * s * hd, s * hd, hd)
    out = []
    for dim, (n, stride, fill) in enumerate(zip((b, h, s), x.stride()[:3], dense)):
        if n == 1:
            stride = fill
        elif (stride * elt) % TMA_BYTES:
            raise ValueError(
                f"flash_attention: stride {stride} of {name}'s dim {dim} is not a "
                f"multiple of {TMA_BYTES} bytes, which TMA needs"
            )
        out.append(stride)
    return tuple(out)


@functools.cache
def _launcher(entry: str):
    fn = getattr(_build.library("flash_attention"), entry)
    ptr = ctypes.c_void_p
    i32 = ctypes.c_int
    i64 = ctypes.c_longlong
    fn.argtypes = [ptr] * 4 + [i32] * 6 + [i64] * 12 + [i32, ctypes.c_float, ptr]
    fn.restype = ctypes.c_int
    return fn


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True
) -> torch.Tensor:
    """Launch the CUDA kernel of the inputs' dtype (:func:`route`); CPU
    tensors take :func:`flash_attention_plain`.  Launches on the current
    stream and does not synchronise."""
    _check(q, k, v)
    check_dtype("flash_attention", q, k, v)
    if check_device("flash_attention", q, k, v) == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    b, h, s, hd = q.shape
    hkv, t = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the kernel takes hd in {HEAD_DIMS}, got {hd}")
    if any(x.stride(3) != 1 for x in (q, k, v)):
        raise ValueError("flash_attention: the head dim of q, k and v must be contiguous")
    kind = route(q.dtype)
    if kind == "tensor_core":
        strides = [tma_strides(n, x) for n, x in (("q", q), ("k", k), ("v", v))]
    else:
        strides = [x.stride()[:3] for x in (q, k, v)]
    out = torch.empty_like(q)  # q's strides where q is dense, else contiguous
    err = _launcher(_ENTRY[kind])(
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
        *strides[0],
        *strides[1],
        *strides[2],
        *out.stride()[:3],
        int(causal),
        float(hd**-0.5),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed with CUDA error {err} "
            f"(B={b}, H={h}, Hkv={hkv}, S={s}, T={t}, hd={hd}, dtype={q.dtype})"
        )
    COUNTS["flash_attention"] += 1
    if kind == "tensor_core":
        COUNTS["tensor_core"] += 1
    return out
