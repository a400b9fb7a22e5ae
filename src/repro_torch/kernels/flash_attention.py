"""The flash-attention kernel's wrapper, its plain PyTorch version, and counts.

Counterpart of ``repro/kernels/flash_attention.py``.  The TPU kernel
``_flash_kernel`` (launched by ``flash_attention_pallas`` on a
``(batch, q_heads, S / 128)`` grid) is ``csrc/flash_attention.cu`` here,
built from source at first use (:mod:`._build`), in three kernels chosen
by dtype and head width before the launch (:func:`route`):

- ``"tensor_core"``: bfloat16 at every multiple of 16 up to 128
  (:data:`TC_HEAD_DIMS`): 128-row query blocks, K/V tiles of 128 keys
  copied by TMA into a three-stage ring, both products on ``wgmma`` with
  fp32 accumulators and the online softmax in fp32;
- ``"cuda_core"``: float32 at the widths the models use
  (:data:`HEAD_DIMS`: 64-row tiles staged in shared memory, all in
  fp32), since TF32 tensor cores would not hold the float32 model paths
  to their tolerance;
- ``"any_width"``: every other head width from 1 to 256, in either dtype:
  the CUDA-core kernel's tiling with the head width an argument, staged
  in fp32.

Past 256 (:data:`MAX_HEAD_DIM`; no decoder the repository configures
has a wider head) a CUDA tensor is refused.

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

Gradients: :func:`flash_attention_fn` is the model's entry point.  Where
autograd records it applies :class:`FlashAttentionFunction`, whose
forward is :func:`flash_attention` and whose backward
(:func:`flash_attention_backward`) is plain PyTorch: the probabilities
recomputed from q and k in chunks of query rows (no S x T matrix for
every head at once), ``dS = P * (dP - rowsum(dO * O))`` from the saved
output, dQ, and dK / dV summed over each KV head's query heads, the
causal mask as in the forward.  The reference has no backward kernel
(its model path differentiates plain jnp attention), so none is written
here.  Elsewhere it calls :func:`flash_attention` itself.

``COUNTS`` holds plain integers: ``flash_attention`` counts kernel
launches, ``tensor_core`` those on the tensor-core route, ``plain`` calls
of the plain version.  :func:`reset_counts` zeroes them.

The dry run's rules (:mod:`._tensors`, inside its ``counting`` scope):
``meta`` inputs get :func:`flash_attention`'s shape rule (``empty_like(q)``,
after the launch's checks: the route's dtype and the 256 ceiling, a
contiguous head dim, TMA's strides on the tensor-core route), and every
call adds :func:`op_count` and :func:`byte_count` at the tile
granularity of the route the inputs take (:func:`tile_walk`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..analysis.contracts import BlockConfig, choice, contract, span
from . import _build
from ._tensors import active, check_device, check_dtype, count, uncounted

__all__ = [
    "COUNTS",
    "FlashAttentionFunction",
    "HEAD_DIMS",
    "MAX_HEAD_DIM",
    "NEG_INF",
    "TC_HEAD_DIMS",
    "byte_count",
    "flash_attention",
    "flash_attention_backward",
    "flash_attention_fn",
    "flash_attention_plain",
    "launch_config",
    "op_count",
    "reset_counts",
    "route",
    "tile_walk",
    "tma_strides",
]

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 80, 128)  # compiled in both dtypes (float32's CUDA-core kernel)
TC_HEAD_DIMS = (16, 32, 48, 64, 80, 96, 112, 128)  # bfloat16 on the tensor cores
MAX_HEAD_DIM = 256  # the any-width kernel's ceiling (csrc anyw::kMaxHeadDim)
TMA_BYTES = 16  # TMA's alignment of a tensor's base address and strides
BACKWARD_CHUNK_ELEMS = 1 << 26  # fp32 scores of one chunk of query rows, all heads
_ENTRY = {  # the C entry point of each route
    "tensor_core": "flash_attention_bf16_launch",
    "cuda_core": "flash_attention_f32_launch",
    "any_width": "flash_attention_any_launch",
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


def route(dtype: torch.dtype, hd: int) -> str:
    """The kernel a CUDA tensor of ``dtype`` and head width ``hd`` takes:
    ``"tensor_core"`` for bfloat16 at :data:`TC_HEAD_DIMS`, ``"cuda_core"``
    for float32 at :data:`HEAD_DIMS`, ``"any_width"`` for any other width
    up to :data:`MAX_HEAD_DIM`; raises past it and for another dtype."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash_attention: no kernel for {dtype}")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: the kernels take hd from 1 to {MAX_HEAD_DIM}, "
                         f"got {hd}")
    if dtype == torch.bfloat16 and hd in TC_HEAD_DIMS:
        return "tensor_core"
    if dtype == torch.float32 and hd in HEAD_DIMS:
        return "cuda_core"
    return "any_width"


def tile_walk(s: int, t: int, causal: bool, kind: str) -> tuple[int, int]:
    """``(pairs, keys)`` of one (sequence, query head) on route ``kind``:
    over the query tiles (128 rows on the tensor cores, 64 on the CUDA
    cores) and the key tiles each visits (128 / 64 keys; when causal only
    those up to the tile's last row, as the kernels' loop bounds, the
    tensor-core kernel's at the last row present, the CUDA-core kernels'
    at the tile's last row), ``pairs`` sums rows x keys visited and
    ``keys`` the keys visited, each tile's keys clipped at ``t``."""
    bm = bn = 128 if kind == "tensor_core" else 64
    n_all = -(-t // bn)
    if not causal:
        return s * t, -(-s // bm) * t
    pairs = keys = 0
    for q0 in range(0, s, bm):
        rows = min(bm, s - q0)
        last = q0 + rows - 1 if kind == "tensor_core" else q0 + bm - 1
        visited = min(min(n_all, last // bn + 1) * bn, t)
        pairs += rows * visited
        keys += visited
    return pairs, keys


def op_count(b: int, h: int, s: int, t: int, hd: int, causal: bool, kind: str) -> int:
    """Operations of one call: q . k and p . v, ``4 * hd`` a (row, key)
    pair of the tiles the kernel visits (:func:`tile_walk`) for each of
    the B x H (sequence, query head) pairs: ``4 * B * H * S * T * hd``
    when not causal."""
    return 4 * b * h * hd * tile_walk(s, t, causal, kind)[0]


def byte_count(b: int, h: int, s: int, t: int, hd: int, causal: bool, kind: str,
               itemsize: int) -> int:
    """Device-memory bytes of one call: q read and the output written once;
    K and V read once per query tile of each query head, over the key
    tiles it visits (:func:`tile_walk`); a group's heads share KV rows,
    which the L2 may serve, and they are counted as read each time."""
    keys = tile_walk(s, t, causal, kind)[1]
    return (2 * b * h * s * hd + 2 * b * h * keys * hd) * itemsize


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
    dtype = [i32] if entry == _ENTRY["any_width"] else []
    fn.argtypes = [ptr] * 4 + [i32] * 6 + [i64] * 12 + [i32, ctypes.c_float] + dtype + [ptr]
    fn.restype = ctypes.c_int
    return fn


def launch_config(kind: str, hd: int) -> BlockConfig:
    """The block a route's kernel launches at head width ``hd``: the
    tensor-core kernel's 128-row Q tile and three-stage K/V ring (+ 1 KB
    of swizzle alignment and the barriers) for 288 threads; the CUDA-core
    kernels' 64-row fp32 Q, K (rows of hd + 1), V and P tiles for 256."""
    if kind == "tensor_core":
        stages = 3
        return BlockConfig(0, 1024 + 128 * hd * 2 + 2 * stages * 128 * hd * 2
                           + 8 * (1 + 2 * stages), 9 * 32)
    return BlockConfig(0, 4 * (2 * 64 * (hd + 1) + 64 * hd + 64 * 65), 256)


def _k6_dispatch(geom: dict) -> str:
    if geom["device"] == "cpu":
        return "plain"
    if not 1 <= geom["hd"] <= MAX_HEAD_DIM:
        return "refused"
    return route(getattr(torch, geom["dtype"]), geom["hd"])


def _k6_signature(geom: dict) -> tuple:
    """The route's kernel and hd (compiled in for the tensor-core and
    float32 kernels, a run-time argument of the any-width one)."""
    return ("flash_attention", _k6_dispatch(geom), geom["dtype"], geom["hd"])


def _k6_abstract(geom: dict):
    dt = getattr(torch, geom["dtype"])
    x = torch.zeros(1, 2, 8, geom["hd"], dtype=dt)
    return flash_attention, (x, x[:, :1], x[:, :1])


@contract(
    "flash_attention.kernel",
    axes=(
        span("hd", 1, MAX_HEAD_DIM, boundaries=(16, 64, 128, MAX_HEAD_DIM),
             past=(MAX_HEAD_DIM + 1, 2 * MAX_HEAD_DIM)),
        choice("dtype", "float32", "bfloat16"),
        choice("device", "cuda", "cpu"),
    ),
    backends=("tensor_core", "cuda_core", "any_width", "plain", "refused"),
    device_backends=("tensor_core", "cuda_core", "any_width"),
    dispatch=_k6_dispatch,
    smem=lambda geom: launch_config(_k6_dispatch(geom), geom["hd"]),
    signature=_k6_signature,
    max_signatures=2 * MAX_HEAD_DIM,  # a dtype and a width each
    abstract=_k6_abstract,
    notes="K6: bf16 at the multiples of 16 up to 128 on the tensor cores, "
    "float32 at 16/32/64/80/128 on the CUDA cores, every other hd up to 256 "
    "on the any-width kernel; past 256 a CUDA tensor is refused",
)
def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True
) -> torch.Tensor:
    """Launch the CUDA kernel of the inputs' dtype and head width
    (:func:`route`); CPU tensors take :func:`flash_attention_plain`.
    Launches on the current stream and does not synchronise."""
    _check(q, k, v)
    code = check_dtype("flash_attention", q, k, v)
    dev = check_device("flash_attention", q, k, v)
    b, h, s, hd = q.shape
    hkv, t = k.shape[1], k.shape[2]
    if dev == "cpu":
        if not active():
            return flash_attention_plain(q, k, v, causal=causal)
        out = torch.empty_like(q)  # the launch's output, in the counters' sight
        with uncounted():
            out.copy_(flash_attention_plain(q, k, v, causal=causal))
        _count(b, h, s, t, hd, causal, q.dtype)
        return out
    kind = route(q.dtype, hd)
    if any(x.stride(3) != 1 for x in (q, k, v)):
        raise ValueError("flash_attention: the head dim of q, k and v must be contiguous")
    if kind == "tensor_core":
        strides = [tma_strides(n, x) for n, x in (("q", q), ("k", k), ("v", v))]
    else:
        strides = [x.stride()[:3] for x in (q, k, v)]
    out = torch.empty_like(q)  # q's strides where q is dense, else contiguous
    if dev == "meta":
        _count(b, h, s, t, hd, causal, q.dtype)
        return out
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
        *((code,) if kind == "any_width" else ()),
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
    if active():
        _count(b, h, s, t, hd, causal, q.dtype)
    return out


def _count(b: int, h: int, s: int, t: int, hd: int, causal: bool, dtype) -> None:
    """One call's counts, at the tiles of the route a CUDA tensor of
    ``dtype`` takes (the plain version's call on the CPU too)."""
    kind = route(dtype, hd)
    count("flash_attention", op_count(b, h, s, t, hd, causal, kind),
          byte_count(b, h, s, t, hd, causal, kind, dtype.itemsize))


def flash_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    dout: torch.Tensor,
    *,
    causal: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of :func:`flash_attention_plain`'s function at
    ``q``, ``k``, ``v`` with output ``out``, for the output gradient
    ``dout``, in fp32, cast to the inputs' dtypes.  Query rows are taken
    in chunks whose (B, H, rows, T) fp32 scores hold at most
    ``BACKWARD_CHUNK_ELEMS`` elements."""
    b, h, s, hd = q.shape
    hkv, t = k.shape[1], k.shape[2]
    g = h // hkv
    scale = hd**-0.5
    qf = q.float().reshape(b, hkv, g, s, hd)
    kf, vf = k.float(), v.float()
    dof = dout.float().reshape(b, hkv, g, s, hd)
    delta = (dof * out.float().reshape(b, hkv, g, s, hd)).sum(-1)  # rowsum(dO * O)
    dq = torch.empty_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    cols = torch.arange(t, device=q.device)
    rows = max(1, min(s, BACKWARD_CHUNK_ELEMS // max(1, b * h * t)))
    for i0 in range(0, s, rows):
        i1 = min(s, i0 + rows)
        qc, doc = qf[:, :, :, i0:i1], dof[:, :, :, i0:i1]
        logits = torch.einsum("bngsh,bnth->bngst", qc, kf) * scale
        if causal:
            keep = torch.arange(i0, i1, device=q.device)[:, None] >= cols[None, :]
            logits = torch.where(keep, logits, NEG_INF)
        p = torch.softmax(logits, dim=-1)
        del logits
        dv += torch.einsum("bngst,bngsh->bnth", p, doc)
        ds = p * (torch.einsum("bngsh,bnth->bngst", doc, vf) - delta[:, :, :, i0:i1, None])
        del p
        dq[:, :, :, i0:i1] = torch.einsum("bngst,bnth->bngsh", ds, kf) * scale
        dk += torch.einsum("bngst,bngsh->bnth", ds, qc) * scale
    return dq.reshape(b, h, s, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttentionFunction(torch.autograd.Function):
    """:func:`flash_attention` forward, :func:`flash_attention_backward`
    backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        out = flash_attention(q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, dout, causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention_fn(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True
) -> torch.Tensor:
    """Attention through K6, differentiable: :class:`FlashAttentionFunction`
    where autograd records, else :func:`flash_attention`."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFunction.apply(q, k, v, causal)
    return flash_attention(q, k, v, causal=causal)
