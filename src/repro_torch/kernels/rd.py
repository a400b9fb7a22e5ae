"""The RD strip kernel's wrapper, its plain PyTorch version, and counts.

Counterpart of ``repro/kernels/rd.py``.  The TPU kernel
``_rd_strip_kernel`` (launched by ``_rd_strip_call`` through
``rd_strip_takes_pallas``) is ``csrc/rd_strip.cu`` here: one thread
block sorts the slot lanes and walks the prefix, built from source at
first use (:mod:`._build`).

One *strip* of device Replica-Deletion (:mod:`repro_torch.core.rd_torch`)
orders the candidate classes by the deletion key and walks the prefix of
their member counts until the strip's quota is spent.  Both functions
here take the kernel's contract:

- ``keys``: int32 ``(R, C)``, rows most-significant first — masked
  ``-count`` (``BIG`` for non-candidates), alt, the P packed holder
  words, group — with R <= :data:`RD_MAX_KEY_ROWS` and C a power of two
  in ``[128,`` :data:`RD_MAX_C` ``]``;
- ``size``: int32 ``(C,)`` member counts; ``quota``: int32, one element;

and return ``(take_sorted, idx)``, both int32 ``(C,)``: ``idx`` sorts
the lanes by the key rows lexicographically with the lane index as the
last tie (so the order is total, and equals a stable lexsort), and
``take_sorted = clip(quota - prev, 0, s)`` where ``s`` is the sorted
member count masked to candidates and ``prev`` its exclusive prefix sum.

- :func:`rd_strip_takes` launches the kernel for a CUDA tensor, or
  raises; it takes the plain version only for a tensor on the CPU.
- :func:`rd_strip_takes_plain` is the same function in plain PyTorch
  (one stable argsort per key row, least significant first).

``COUNTS`` holds plain integers: ``rd_strip`` counts kernel launches,
``plain`` counts calls of the plain version.  :func:`reset_counts`
zeroes them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = [
    "BIG",
    "COUNTS",
    "RD_MAX_C",
    "RD_MAX_KEY_ROWS",
    "rd_fits",
    "rd_strip_takes",
    "rd_strip_takes_plain",
    "reset_counts",
]

BIG = 2**30  # non-candidate sentinel of the primary key row
MIN_LANES = 128  # the reference's lane floor (its slot capacity is >= 128)
# the reference's single-block bounds (RD_PALLAS_MAX_C / _KEY_ROWS); the
# device RD caps its slot capacity at RD_MAX_C and rejects wider key blocks
RD_MAX_C = 1 << 14
RD_MAX_KEY_ROWS = 24

COUNTS = {"rd_strip": 0, "plain": 0}


def reset_counts() -> None:
    for key in COUNTS:
        COUNTS[key] = 0


def rd_fits(c_slots: int, n_key_rows: int) -> bool:
    """True when the slot geometry fits the single-block kernel."""
    return c_slots <= RD_MAX_C and n_key_rows <= RD_MAX_KEY_ROWS


def rd_strip_takes_plain(
    keys: torch.Tensor, size: torch.Tensor, quota: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, for any ``(R, C)`` block.

    ``torch`` has no lexsort: stable argsorts chained from the least
    significant row to the most significant realize it, starting from
    the identity so the lane index is the last tie.  Every intermediate
    stays int32, so sums wrap exactly as in the reference and the kernel.
    """
    COUNTS["plain"] += 1
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


def _check(keys: torch.Tensor, size: torch.Tensor, quota: torch.Tensor) -> None:
    for name, t in (("keys", keys), ("size", size), ("quota", quota)):
        if t.dtype != torch.int32:
            raise TypeError(f"rd_strip: {name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"rd_strip: {name} must be contiguous")
        if t.device != keys.device:
            raise ValueError("rd_strip: keys, size and quota must share a device")
    if keys.dim() != 2 or size.shape != keys.shape[1:] or quota.numel() != 1:
        raise ValueError(
            f"rd_strip: shapes keys {tuple(keys.shape)}, size "
            f"{tuple(size.shape)}, quota {tuple(quota.shape)} do not form "
            "(R, C), (C,), one element"
        )
    n_rows, n_lanes = keys.shape
    if n_lanes < MIN_LANES or n_lanes & (n_lanes - 1):
        raise ValueError(
            f"rd_strip: slot lanes must be a power of two >= {MIN_LANES}, "
            f"got {n_lanes}"
        )
    if n_rows < 1 or not rd_fits(n_lanes, n_rows):
        raise ValueError(
            f"rd_strip: slot geometry ({n_rows} rows, {n_lanes} lanes) is "
            f"outside the kernel's bounds ({RD_MAX_KEY_ROWS} rows, "
            f"{RD_MAX_C} lanes)"
        )


@functools.cache
def _launcher():
    fn = _build.library("rd_strip").rd_strip_launch
    ptr = ctypes.c_void_p
    fn.argtypes = [ptr] * 5 + [ctypes.c_int, ctypes.c_int, ptr]
    fn.restype = ctypes.c_int
    return fn


def rd_strip_takes(
    keys: torch.Tensor, size: torch.Tensor, quota: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on one strip's key block; CPU tensors take
    :func:`rd_strip_takes_plain`.  Launches on the current stream and
    does not synchronise."""
    _check(keys, size, quota)
    if keys.device.type == "cpu":
        return rd_strip_takes_plain(keys, size, quota)
    if keys.device.type != "cuda":
        raise ValueError(f"rd_strip: unsupported device {keys.device}")
    if keys.device.index != torch.cuda.current_device():
        raise ValueError(
            f"rd_strip: tensors on {keys.device} but the current device is "
            f"cuda:{torch.cuda.current_device()}"
        )
    n_rows, n_lanes = keys.shape
    take = torch.empty_like(size)
    idx = torch.empty_like(size)
    err = _launcher()(
        keys.data_ptr(),
        size.data_ptr(),
        quota.data_ptr(),
        take.data_ptr(),
        idx.data_ptr(),
        n_rows,
        n_lanes,
        torch.cuda.current_stream(keys.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"rd_strip kernel launch failed with CUDA error {err} "
            f"(R={n_rows}, C={n_lanes})"
        )
    COUNTS["rd_strip"] += 1
    return take, idx
