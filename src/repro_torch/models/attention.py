"""Attention: grouped-query attention with the qk-norm / qkv-bias options.

The port's counterpart of the GQA half of ``repro/models/attention.py``.
Two execution paths share the same parameters:

- :func:`gqa_prefill` — causal self-attention over whole prompts through
  the flash-attention kernel (K6), returning the prompt's keys and
  values for the decode cache;
- :func:`gqa_decode` — single-token decode against the KV cache: the new
  row is written into the cache in place, then attention runs through
  the decode-attention kernel (K5).

The port keeps each layer's KV cache as ``(B, Hkv, S_max, hd)``, the
layout K5 reads; the reference keeps ``(B, S_max, Hkv, hd)``.  MLA,
cross-attention and the training-time ``gqa_attend`` wait for later
slices.
"""

from __future__ import annotations

import torch
from torch import nn

from ..kernels import ops
from .config import ModelConfig
from .layers import Dense, RMSNorm, dense, dense_init_, rmsnorm
from .rope import rope_tables, rotate

__all__ = [
    "GQA",
    "Rope",
    "Slots",
    "cache_slots",
    "gqa_decode",
    "gqa_init_",
    "gqa_prefill",
    "rope_for",
    "sdpa",
    "write_rows",
]

Rope = tuple[torch.Tensor, torch.Tensor]  # cos, sin from rope_tables
Slots = tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # from cache_slots


class GQA(nn.Module):
    """Projections ``wq``/``wk``/``wv``/``wo`` (+ ``q_norm``/``k_norm``)."""

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        h, dt = cfg.head_dim_, cfg.torch_dtype
        d, nq, nkv = cfg.d_model, cfg.n_heads * h, cfg.n_kv_heads * h
        bias = cfg.qkv_bias
        self.wq = Dense(d, nq, bias=bias, dtype=dt, device=device)
        self.wk = Dense(d, nkv, bias=bias, dtype=dt, device=device)
        self.wv = Dense(d, nkv, bias=bias, dtype=dt, device=device)
        self.wo = Dense(nq, d, bias=False, dtype=dt, device=device)
        if cfg.qk_norm:
            self.q_norm = RMSNorm(h, dtype=dt, device=device)
            self.k_norm = RMSNorm(h, dtype=dt, device=device)


def gqa_init_(p: GQA, generator: torch.Generator) -> None:
    for proj in (p.wq, p.wk, p.wv, p.wo):
        dense_init_(proj, generator)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool) -> torch.Tensor:
    """Grouped-query attention core through K6.

    q: (B, S, H, hd); k/v: (B, T, Hkv, hd) → (B, S, H, hd).  The kernel
    reads the transposed views through their strides (no copy) and
    writes its output with q's strides.
    """
    out = ops.flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=causal
    )
    return out.transpose(1, 2)


def rope_for(cfg: ModelConfig, positions: torch.Tensor) -> Rope:
    """The rotation tables of ``positions`` (B, S), shared by every layer's
    queries and keys (the reference recomputes them per use: same
    values)."""
    return rope_tables(positions, cfg.head_dim_, cfg.rope_theta)


def _project_qkv(p: GQA, cfg: ModelConfig, x: torch.Tensor, rope: Rope):
    b, s, _ = x.shape
    h = cfg.head_dim_
    q = dense(p.wq, x).reshape(b, s, cfg.n_heads, h)
    k = dense(p.wk, x).reshape(b, s, cfg.n_kv_heads, h)
    v = dense(p.wv, x).reshape(b, s, cfg.n_kv_heads, h)
    if cfg.qk_norm:
        q = rmsnorm(p.q_norm, q, cfg.norm_eps)
        k = rmsnorm(p.k_norm, k, cfg.norm_eps)
    return rotate(q, *rope), rotate(k, *rope), v


def gqa_prefill(
    p: GQA, cfg: ModelConfig, x: torch.Tensor, rope: Rope
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefill: full causal attention, ``rope`` from :func:`rope_for` of the
    prompt positions.  Returns the output and the prompt's keys and
    values as ``(B, Hkv, S, hd)`` views."""
    q, k, v = _project_qkv(p, cfg, x, rope)
    out = sdpa(q, k, v, causal=True)
    b, s = x.shape[:2]
    out = out.reshape(b, s, cfg.n_heads * cfg.head_dim_)
    return dense(p.wo, out), k.transpose(1, 2), v.transpose(1, 2)


def cache_slots(pos: torch.Tensor, s_max: int) -> Slots:
    """Where :func:`write_rows` writes for positions ``pos`` (B,) in a cache
    of ``s_max`` positions: the sequence index, the clamped position and
    whether the position lies inside the cache (shared by every layer)."""
    bi = torch.arange(pos.shape[0], device=pos.device)
    return bi, pos.clamp(max=s_max - 1).long(), (pos < s_max)[:, None, None]


def write_rows(cache: torch.Tensor, rows: torch.Tensor, slots: Slots) -> None:
    """``cache[b, :, pos[b]] = rows[b]`` in place, for every sequence b.

    cache: (B, Hkv, S_max, hd); rows: (B, Hkv, hd); slots from
    :func:`cache_slots`.  As the reference's masked write, a position
    past the cache writes nothing (it is clamped and rewritten with the
    row already there), and no host sync is needed to find out.
    """
    bi, at, inside = slots
    cache[bi, :, at] = torch.where(inside, rows.to(cache.dtype), cache[bi, :, at])


def gqa_decode(
    p: GQA,
    cfg: ModelConfig,
    x: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    pos: torch.Tensor,
    rope: Rope,
    slots: Slots,
) -> torch.Tensor:
    """One-token decode.  ``cache_k``/``cache_v``: (B, Hkv, S_max, hd),
    updated in place with this token's row at ``pos`` (B,), the current
    write index of every sequence (pad-fed slots included); keys past
    ``pos`` are masked out.  ``rope`` is :func:`rope_for` of
    ``pos[:, None]`` and ``slots`` :func:`cache_slots` of ``pos``."""
    b = x.shape[0]
    q, k_new, v_new = _project_qkv(p, cfg, x, rope)
    write_rows(cache_k, k_new[:, 0], slots)
    write_rows(cache_v, v_new[:, 0], slots)
    out = ops.decode_attention(q[:, 0], cache_k, cache_v, pos)
    return dense(p.wo, out.reshape(b, 1, cfg.n_heads * cfg.head_dim_))
