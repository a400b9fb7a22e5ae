"""int8 gradient compression with error feedback (the data-parallel
all-reduce trick).

The port's counterpart of ``repro/train/compress.py``, written as SPMD
per-rank code on ``torch.distributed``: each rank computes the gradient
of its own shard of the batch, quantizes it to int8 against a scale
common to the axis (one fp32 ``all_reduce(MAX)``), sums the int8 payload
as int32 over the axis (int8 would overflow past one rank's +-127),
dequantizes and divides by the axis size, and keeps the quantization
residual in its error-feedback buffer, added to the next step's gradient.

The reference marks the parameters device-varying (``pvary``) so that
``shard_map`` does not sum their cotangents for it; here the parameters
are plain tensors, every rank's own copy, so ``grad_fn`` returns the
rank's own gradient, which is what gets quantized.  The error-feedback
state is the rank's ``(1, *shape)`` block of the reference's
``(n_dev, *shape)`` buffer.

This is the optional distributed-optimization path; the sharded train
step (:mod:`repro_torch.train.step`) keeps exact reductions.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

import torch
import torch.distributed as dist

from ..parallel.sharding import mesh_sizes
from .optim import tree_map

__all__ = [
    "dequantize_int8",
    "init_error_state",
    "make_compressed_grad_fn",
    "quantize_int8",
]


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(q, scale)``: ``x`` rounded (half to even) in units of ``scale =
    max|x| / 127`` (at least 1e-12 / 127), clipped to +-127, as int8; the
    scale fp32."""
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_state(params: Any) -> Any:
    """This rank's error-feedback residuals: a ``(1, *shape)`` fp32 zero
    block per parameter leaf."""
    return tree_map(lambda p: torch.zeros((1,) + tuple(p.shape), dtype=torch.float32,
                                          device=p.device), params)


def _compress_one(g: torch.Tensor, err: torch.Tensor, group, n: int):
    corrected = g.float() + err[0]
    # every rank quantizes against a common scale, or the int payloads
    # would sum incompatible units
    scale = torch.clamp(corrected.abs().max(), min=1e-12) / 127.0
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    q = torch.clamp(torch.round(corrected / scale), -127, 127).to(torch.int8)
    new_err = corrected - dequantize_int8(q, scale)
    total = q.to(torch.int32)
    dist.all_reduce(total, group=group)  # the int payload on the wire
    mean = dequantize_int8(total, scale) / n
    return mean.to(g.dtype), new_err[None]


def _shard(batch: Any, index: int, n: int) -> Any:
    """This rank's rows (the leading dim cut in ``n``) of every leaf."""
    if isinstance(batch, Mapping):
        return {k: _shard(v, index, n) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(_shard(v, index, n) for v in batch)
    rows = batch.shape[0] // n
    return batch[index * rows:(index + 1) * rows]


def make_compressed_grad_fn(grad_fn: Callable, mesh, axis: str = "data") -> Callable:
    """Wrap ``grad_fn(params, batch) -> grads`` with the int8 reduction
    over the mesh axis ``axis``.

    Returns ``fn(params, batch, err) -> (mean_grads, new_err)``, called by
    every rank: ``params`` the same on every rank, ``batch`` the global
    batch (every leaf's leading dim is cut into the axis's shards, and
    this rank differentiates its own), ``err`` this rank's residuals
    (:func:`init_error_state`).  ``mean_grads`` is the same on every rank
    of the axis."""
    group = mesh.get_group(axis)
    n = mesh_sizes(mesh)[axis]
    index = mesh.get_local_rank(axis)

    def run(params, batch, err):
        local = grad_fn(params, _shard(batch, index, n))
        pairs = tree_map(lambda g, e: _compress_one(g, e, group, n), local, err)
        return tree_map(lambda t: t[0], pairs), tree_map(lambda t: t[1], pairs)

    return run
