"""Basic layers: parameter modules, initializers, norms, embeddings, projections.

The port's counterpart of ``repro/models/layers.py``.  Parameters live in
small :class:`torch.nn.Module` s whose attribute names are the keys of
the reference's parameter tree (``w``/``b``, ``g``, ``table``), so
:func:`repro_torch.convert.from_reference_params` maps one onto the
other by name.  Weights keep the reference's ``(fan_in, fan_out)``
layout: a projection is ``x @ w``.  Parameters are created in the
config's dtype without ``requires_grad`` (serving needs none; the train
step, :mod:`repro_torch.train.step`, turns it on); norm math runs in
fp32 and casts back.  A rank holds plain tensors (its own blocks:
:mod:`repro_torch.parallel`), so the reference's sharding constraints
have no counterpart here.
"""

from __future__ import annotations

import torch
from torch import nn

from ..kernels import ops

__all__ = [
    "Dense",
    "Embed",
    "RMSNorm",
    "dense",
    "dense_init_",
    "embed",
    "embed_init_",
    "rmsnorm",
    "unembed",
]


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Dense(nn.Module):
    """``w`` (fan_in, fan_out) and, with ``bias``, ``b`` (fan_out,)."""

    def __init__(self, fan_in: int, fan_out: int, *, bias: bool, dtype, device):
        super().__init__()
        self.w = _frozen(torch.empty(fan_in, fan_out, dtype=dtype, device=device))
        self.b = _frozen(torch.zeros(fan_out, dtype=dtype, device=device)) if bias else None


class RMSNorm(nn.Module):
    """Gain ``g`` (d,), ones at init."""

    def __init__(self, d: int, *, dtype, device):
        super().__init__()
        self.g = _frozen(torch.ones(d, dtype=dtype, device=device))


class Embed(nn.Module):
    """``table`` (vocab, d): the embedding, and the unembedding's weight."""

    def __init__(self, vocab: int, d: int, *, dtype, device):
        super().__init__()
        self.table = _frozen(torch.empty(vocab, d, dtype=dtype, device=device))


def _normal(t: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """Fill ``t`` with N(0, std²) drawn in fp32, then cast, as the
    reference draws its initial weights."""
    noise = torch.randn(t.shape, generator=generator, dtype=torch.float32, device=t.device)
    t.copy_(noise.mul_(std))


@torch.no_grad()
def dense_init_(p: Dense, generator: torch.Generator, *, scale: float = 1.0) -> None:
    """Variance-scaled normal init (std = scale / sqrt(fan_in)); bias zero."""
    _normal(p.w, scale / p.w.shape[0] ** 0.5, generator)
    if p.b is not None:
        p.b.zero_()


@torch.no_grad()
def embed_init_(p: Embed, generator: torch.Generator) -> None:
    _normal(p.table, 0.02, generator)


def dense(p: Dense, x: torch.Tensor) -> torch.Tensor:
    """Projection over the last axis: ``x @ w (+ b)``."""
    y = x @ p.w
    if p.b is not None:
        y = y + p.b
    return y


def rmsnorm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis through the fused kernel (K4)."""
    return ops.rmsnorm_fused(x, p.g, eps=eps)


def embed(p: Embed, tokens: torch.Tensor) -> torch.Tensor:
    return nn.functional.embedding(tokens, p.table)


def unembed(p: Embed, x: torch.Tensor) -> torch.Tensor:
    """Vocab logits: the product in the model dtype, then fp32 (a stable
    softmax / argmax downstream), as the reference's einsum + astype."""
    return (x @ p.table.T).float()
