"""The water-level kernel's wrapper, its plain PyTorch version, and counts.

Counterpart of ``repro/kernels/waterlevel.py``.  The TPU kernel
``_waterlevel_kernel`` (launched by ``_waterlevel_call_padded`` and its
``(B,)``-grid twin ``_waterlevel_call_padded_batch``) is
``csrc/waterlevel.cu`` here: one CUDA kernel, one thread block per
problem row, built from source at first use (:mod:`._build`).

Both functions take the kernel's contract: pre-masked int32 rows ``b``,
``w`` of shape ``(B, n_lanes)`` (pad and masked lanes carry ``b = BIG``,
``w = 0``) and ``demand`` of shape ``(B,)``, and return
``(level (B,), take_sorted (B, n_lanes), idx_sorted (B, n_lanes))``:
the water level, the Alg. 2 takes in ascending ``(busy, lane)`` order,
and the permutation that order applies.

- :func:`waterlevel_sorted` launches the kernel for a CUDA tensor, or
  raises; it takes the plain version only for a tensor on the CPU.
- :func:`waterlevel_sorted_plain` is the same function in plain PyTorch
  (argsort + cumsum).  It accepts any row width, so the ``torch``
  water-level route runs it on unpadded rows as well.

``COUNTS`` holds plain integers: ``waterlevel`` and ``waterlevel_batch``
count kernel launches over one row and over several rows, ``plain``
counts calls of the plain version.  :func:`reset_counts` zeroes them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import backend
from . import _build

__all__ = [
    "BIG",
    "COUNTS",
    "MAX_LANES",
    "SMEM_MAX_LANES",
    "n_lanes_for",
    "reset_counts",
    "resolve_waterlevel",
    "waterlevel_sorted",
    "waterlevel_sorted_plain",
]

BIG = 2**30  # masked and pad lanes sort past every real lane
LANES = 128  # minimum padded width (the reference's lane floor)
MAX_LANES = 1 << 15  # kernel ceiling, the reference's PALLAS_MAX_M
SMEM_MAX_LANES = 1 << 14  # widest row resident in one block's shared memory
SCRATCH_BYTES_PER_LANE = 12  # 8 B key + 4 B w, for rows past SMEM_MAX_LANES

COUNTS = {"waterlevel": 0, "waterlevel_batch": 0, "plain": 0}


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
def _launcher():
    fn = _build.library("waterlevel").waterlevel_launch
    ptr = ctypes.c_void_p
    fn.argtypes = [ptr] * 7 + [ctypes.c_int, ctypes.c_int, ptr]
    fn.restype = ctypes.c_int
    return fn


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
    scratch = None
    if n > SMEM_MAX_LANES:
        scratch = torch.empty(
            bsz * n * SCRATCH_BYTES_PER_LANE, dtype=torch.uint8, device=b.device
        )
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
        torch.cuda.current_stream(b.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"waterlevel kernel launch failed with CUDA error {err} "
            f"(B={bsz}, n_lanes={n})"
        )
    COUNTS["waterlevel" if bsz == 1 else "waterlevel_batch"] += 1
    return level, take, idx
