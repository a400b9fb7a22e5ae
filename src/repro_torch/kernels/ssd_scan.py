"""The SSD chunk-scan kernel's wrapper, its plain PyTorch version, and counts.

Counterpart of ``repro/kernels/ssd_scan.py``.  The TPU kernel
``_ssd_kernel`` (launched by ``ssd_scan_pallas`` on a ``(batch, heads)``
grid over 128-row chunks, ``S % 128 == 0``, ``y`` in ``x``'s dtype) is
``csrc/ssd_scan.cu`` here, on the contract of the model's
``ssm.ssd_chunked`` (with ``h0=None``), which is what the model runs:

- ``x`` ``(B, S, H, P)`` in float32 or bfloat16, ``dt`` ``(B, S, H)``
  float32 (post-softplus), ``a`` ``(H,)`` float32 (negative), ``bm`` and
  ``cm`` ``(B, S, N)`` in ``x``'s dtype;
- returns ``y`` ``(B, S, H, P)`` float32 and the final state ``h_last``
  ``(B, H, P, N)`` float32, the state starting at zero, for any
  ``S >= 1``.

The kernel reads its inputs through their strides (only the last dim
need be contiguous), so the model hands over its slices of the conv
output without a copy; it is built from source at first use
(:mod:`._build`).  It takes one of two routes (:func:`route`):

- ``tensor_core`` for bfloat16 (the models' prefill): two launches over
  64-row chunks — the chunk states and their carry, one block per
  (sequence, head) walking the chunks, then y with every chunk in
  parallel, one C·Bᵀ per block shared by its heads — every product a
  bf16 ``mma.sync`` whose fp32 operand is split in three bf16 terms, so
  that it keeps fp32 accuracy; it needs a scratch of
  :func:`scratch_bytes` (the state entering each chunk), which the
  wrapper allocates;
- ``cuda_core`` for float32: one block per (sequence, head) walking the
  64-row tiles in order, in fp32 on the CUDA cores.

- :func:`ssd_scan` launches the kernel for a CUDA tensor, or raises; it
  takes the plain version only for a tensor on the CPU.
- :func:`ssd_scan_plain` is the same function in plain PyTorch: the
  port's copy of the reference model's chunked arithmetic
  (:func:`ssd_chunked_plain`) at the chunk the caller passes, the
  sequence padded to a whole number of chunks with rows that add no
  input and no decay (``dt = 0``).  At the model's chunk it computes
  what the reference model computes.

Gradients: :func:`ssd_scan_fn` is the model's entry point.  Where
autograd records it applies :class:`SSDScanFunction`, whose forward is
:func:`ssd_scan` and whose backward differentiates a recompute of the
chunked scan in plain PyTorch (:func:`ssd_chunked_plain` at the caller's
chunk, uncounted) under autograd: the reference differentiates its plain
jnp scan and has no backward kernel.  Elsewhere it calls
:func:`ssd_scan` itself.

``COUNTS`` holds plain integers: ``ssd_scan`` counts kernel calls (one
per :func:`ssd_scan` call on the card, whatever its route's number of
launches), ``tensor_core`` those of them on the tensor-core route,
``plain`` counts calls of the plain version.  :func:`reset_counts`
zeroes them.

The dry run's rules (:mod:`._tensors`, inside its ``counting`` scope):
``meta`` inputs get :func:`ssd_scan`'s shape rule (``y`` and ``h_last``
in fp32, and the tensor-core route's scratch, after the launch's
checks), and every call adds :func:`op_count` and :func:`byte_count` at
the kernel's 64-row chunks, not the plain version's.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.nn import functional as F

from . import _build
from ._tensors import active, check_device, check_dtype, count, uncounted

__all__ = [
    "CHUNK",
    "COUNTS",
    "SSDScanFunction",
    "HEAD_DIMS",
    "STATE_DIMS",
    "byte_count",
    "op_count",
    "reset_counts",
    "route",
    "scratch_bytes",
    "ssd_chunked_plain",
    "ssd_scan",
    "ssd_scan_fn",
    "ssd_scan_plain",
]

CHUNK = 256  # the plain version's default chunk: the models' SSMConfig.chunk
HEAD_DIMS = (16, 32, 64)  # the kernel's compiled P
STATE_DIMS = (16, 32, 64, 128)  # the kernel's compiled N

TILE = 64  # the kernel's rows per chunk (csrc/ssd_scan.cu kQ)

COUNTS = {"ssd_scan": 0, "tensor_core": 0, "plain": 0}


def reset_counts() -> None:
    for key in COUNTS:
        COUNTS[key] = 0


def _segsum_exp(da: torch.Tensor) -> torch.Tensor:
    """``exp`` of the lower-triangular segment sums of ``da`` (..., Q):
    out[..., i, j] = exp(cs_i - cs_j) for j <= i, else 0, with ``cs`` the
    cumulative sum (the reference's ``exp(_segsum(.))``)."""
    q = da.shape[-1]
    cs = torch.cumsum(da, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones(q, q, dtype=torch.bool, device=da.device))
    return torch.exp(torch.where(mask, diff, -torch.inf))


def ssd_chunked_plain(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    bm: torch.Tensor,
    cm: torch.Tensor,
    chunk: int,
    h0: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``ssm.ssd_chunked``, step for step: x (B, S, H, P),
    dt (B, S, H), a (H,), bm/cm (B, S, N), ``S % min(chunk, S) == 0``;
    returns (y (B, S, H, P) fp32, final state (B, H, P, N) fp32)."""
    b, s, nh, p = x.shape
    n = bm.shape[-1]
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"ssd_chunked_plain: sequence {s} does not divide chunk {q}")
    c = s // q
    f32 = torch.float32
    xd = (x.to(f32) * dt[..., None]).to(f32)  # fold dt into the inputs
    da = (dt * a[None, None, :]).to(f32)  # (B, S, H) <= 0

    xc = xd.reshape(b, c, q, nh, p)
    dac = da.reshape(b, c, q, nh)
    bc = bm.reshape(b, c, q, n).to(f32)
    cc = cm.reshape(b, c, q, n).to(f32)

    # intra-chunk (quadratic dual form)
    L = _segsum_exp(dac.permute(0, 1, 3, 2))  # (B, C, H, Q, Q)
    scores = torch.einsum("bcin,bcjn->bcij", cc, bc)  # (B, C, Q, Q)
    y_diag = torch.einsum("bchij,bcjhp->bcihp", scores[:, :, None] * L, xc)

    # chunk states: decay from each position to the chunk's end
    cum = torch.cumsum(dac, dim=2)  # (B, C, Q, H)
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)
    states = torch.einsum("bcqn,bcqh,bcqhp->bchpn", bc, decay_end, xc)

    # inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (B, C, H)
    h = torch.zeros(b, nh, p, n, dtype=f32, device=x.device) if h0 is None else h0.to(f32)
    h_prev = []
    for ci in range(c):
        h_prev.append(h)
        h = h * chunk_decay[:, ci, :, None, None] + states[:, ci]
    h_prev = torch.stack(h_prev, dim=1)  # (B, C, H, P, N)

    # inter-chunk contribution: decay from the chunk's start to the position
    y_off = torch.einsum("bcqn,bcqh,bchpn->bcqhp", cc, torch.exp(cum), h_prev)
    y = (y_diag + y_off).reshape(b, s, nh, p)
    return y, h


def ssd_scan_plain(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    bm: torch.Tensor,
    cm: torch.Tensor,
    chunk: int = CHUNK,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, at ``chunk``."""
    COUNTS["plain"] += 1
    return _padded_chunked(x, dt, a, bm, cm, chunk)


def _padded_chunked(x, dt, a, bm, cm, chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`ssd_chunked_plain` over ``S`` padded to whole chunks."""
    s = x.shape[1]
    q = min(chunk, s)
    pad = -s % q
    if pad:  # rows with dt = 0 and zero inputs: no input, no decay
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bm = F.pad(bm, (0, 0, 0, pad))
        cm = F.pad(cm, (0, 0, 0, pad))
    y, h_last = ssd_chunked_plain(x, dt, a, bm, cm, q)
    return y[:, :s], h_last


def _check(x, dt, a, bm, cm) -> None:
    if x.dim() != 4 or dt.dim() != 3 or a.dim() != 1 or bm.dim() != 3 or bm.shape != cm.shape:
        raise ValueError(
            f"ssd_scan: shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, a "
            f"{tuple(a.shape)}, bm {tuple(bm.shape)}, cm {tuple(cm.shape)} do not form "
            f"(B, S, H, P), (B, S, H), (H,), (B, S, N) x 2"
        )
    b, s, h, _ = x.shape
    if dt.shape != (b, s, h) or a.shape != (h,) or bm.shape[:2] != (b, s):
        raise ValueError(
            f"ssd_scan: x {tuple(x.shape)} disagrees with dt {tuple(dt.shape)}, "
            f"a {tuple(a.shape)} or bm {tuple(bm.shape)}"
        )
    if s < 1 or b < 1 or h < 1:
        raise ValueError("ssd_scan: empty sequence, batch or heads")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError(f"ssd_scan: dt and a must be float32, got {dt.dtype}, {a.dtype}")


def route(dtype: torch.dtype) -> str:
    """The kernel's route for inputs of ``dtype``: ``"tensor_core"`` for
    bfloat16, ``"cuda_core"`` for float32."""
    return "tensor_core" if dtype == torch.bfloat16 else "cuda_core"


def scratch_bytes(b: int, s: int, h: int, p: int, n: int, dtype: torch.dtype) -> int:
    """Scratch bytes of the tensor-core route: the (P, N) fp32 state
    entering each chunk, per sequence and head; 0 for float32."""
    if route(dtype) != "tensor_core":
        return 0
    return 4 * b * (-(-s // TILE)) * h * p * n


def op_count(b: int, s: int, h: int, p: int, n: int) -> int:
    """Operations of one call: the chunked dual form's products at the
    kernel's 64-row chunks (the last one whole), two a multiply-add: per
    sequence and chunk C . B^T once (``2 Q^2 N``: the heads share B and
    C), and per head the scores times x (``2 Q^2 P``), the chunk's local
    state (``2 Q P N``) and the entering state's share of y (``2 Q N P``).
    The same on both routes (the bf16 route runs each of the last three
    as three bf16 ``mma`` s, one per term of its split fp32 operand; the
    float32 route skips score blocks above the diagonal); the decays and
    the carry, elementwise, are not counted."""
    chunks = -(-s // TILE)
    return b * chunks * (2 * TILE * TILE * n + h * (2 * TILE * TILE * p + 4 * TILE * p * n))


def byte_count(b: int, s: int, h: int, p: int, n: int, itemsize: int, kind: str) -> int:
    """Device-memory bytes of one call on route ``kind``: x, dt, a, B and C
    read, y and h_last (fp32) written, once; the tensor-core route's two
    launches read x, dt and B once each and write then read the scratch.
    B and C re-read by a launch's blocks of other heads (from the L2) are
    not counted."""
    x, dt, bc = b * s * h * p * itemsize, b * s * h * 4, b * s * n * itemsize
    out = 4 * (b * s * h * p + b * h * p * n)
    once = x + dt + 2 * bc + 4 * h + out
    if kind != "tensor_core":
        return once
    return once + x + dt + bc + 2 * scratch_bytes(b, s, h, p, n, torch.bfloat16)


@functools.cache
def _launcher():
    fn = _build.library("ssd_scan").ssd_scan_launch
    ptr = ctypes.c_void_p
    i32 = ctypes.c_int
    fn.argtypes = [ptr] * 8 + [i32] * 5 + [ctypes.c_longlong] * 10 + [i32, ptr]
    fn.restype = ctypes.c_int
    return fn


def ssd_scan(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    bm: torch.Tensor,
    cm: torch.Tensor,
    *,
    chunk: int = CHUNK,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel (its route by dtype, :func:`route`); CPU
    tensors take :func:`ssd_scan_plain` at ``chunk`` (the kernel computes
    the same scan at its own 64-row chunks).  Launches on the current
    stream and does not synchronise."""
    _check(x, dt, a, bm, cm)
    code = check_dtype("ssd_scan", x, bm, cm)
    dev = check_device("ssd_scan", x, dt, a, bm, cm)
    b, s, h, p = x.shape
    n = bm.shape[-1]
    if dev == "cpu":
        if not active():
            return ssd_scan_plain(x, dt, a, bm, cm, chunk)
        # the launch's outputs and scratch, in the counters' sight
        y = torch.empty(b, s, h, p, dtype=torch.float32)
        h_last = torch.empty(b, h, p, n, dtype=torch.float32)
        scratch = torch.empty(scratch_bytes(b, s, h, p, n, x.dtype), dtype=torch.uint8)
        with uncounted():
            for out, plain in zip((y, h_last), ssd_scan_plain(x, dt, a, bm, cm, chunk)):
                out.copy_(plain)
        del scratch
        _count(b, s, h, p, n, x.dtype)
        return y, h_last
    if p not in HEAD_DIMS or n not in STATE_DIMS:
        raise ValueError(
            f"ssd_scan: the kernel takes P in {HEAD_DIMS} and N in {STATE_DIMS}, "
            f"got P={p}, N={n}"
        )
    if x.stride(3) != 1 or bm.stride(2) != 1 or cm.stride(2) != 1 or not a.is_contiguous():
        raise ValueError("ssd_scan: the last dim of x, bm and cm, and a, must be contiguous")
    y = torch.empty(b, s, h, p, dtype=torch.float32, device=x.device)
    h_last = torch.empty(b, h, p, n, dtype=torch.float32, device=x.device)
    nbytes = scratch_bytes(b, s, h, p, n, x.dtype)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=x.device) if nbytes else None
    if dev == "meta":
        _count(b, s, h, p, n, x.dtype)
        return y, h_last
    err = _launcher()(
        x.data_ptr(),
        dt.data_ptr(),
        a.data_ptr(),
        bm.data_ptr(),
        cm.data_ptr(),
        y.data_ptr(),
        h_last.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        b,
        s,
        h,
        p,
        n,
        *x.stride()[:3],
        *dt.stride(),
        *bm.stride()[:2],
        *cm.stride()[:2],
        code,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"ssd_scan kernel launch failed with CUDA error {err} "
            f"(B={b}, S={s}, H={h}, P={p}, N={n}, dtype={x.dtype})"
        )
    COUNTS["ssd_scan"] += 1
    if nbytes:
        COUNTS["tensor_core"] += 1
    if active():
        _count(b, s, h, p, n, x.dtype)
    return y, h_last


def _count(b: int, s: int, h: int, p: int, n: int, dtype) -> None:
    count("ssd_scan", op_count(b, s, h, p, n),
          byte_count(b, s, h, p, n, dtype.itemsize, route(dtype)))


class SSDScanFunction(torch.autograd.Function):
    """:func:`ssd_scan` forward; backward through a recompute of the
    chunked scan in plain PyTorch at ``chunk``."""

    @staticmethod
    def forward(ctx, x, dt, a, bm, cm, chunk: int):
        ctx.save_for_backward(x, dt, a, bm, cm)
        ctx.chunk = chunk
        return ssd_scan(x, dt, a, bm, cm, chunk=chunk)

    @staticmethod
    def backward(ctx, dy, dh):
        saved = ctx.saved_tensors
        wanted = [i for i in range(5) if ctx.needs_input_grad[i]]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(i in wanted) for i, t in enumerate(saved)]
            y, h_last = _padded_chunked(*inputs, ctx.chunk)
            grads = torch.autograd.grad((y, h_last), [inputs[i] for i in wanted], (dy, dh))
        out = [None] * 6
        for i, gr in zip(wanted, grads):
            out[i] = gr
        return tuple(out)


def ssd_scan_fn(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    bm: torch.Tensor,
    cm: torch.Tensor,
    *,
    chunk: int = CHUNK,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The SSD scan through K7, differentiable: :class:`SSDScanFunction`
    where autograd records, else :func:`ssd_scan`."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, a, bm, cm)):
        return SSDScanFunction.apply(x, dt, a, bm, cm, chunk)
    return ssd_scan(x, dt, a, bm, cm, chunk=chunk)
