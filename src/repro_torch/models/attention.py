"""Attention: grouped-query attention with the qk-norm / qkv-bias options,
and DeepSeek-style MLA.

The port's counterpart of ``repro/models/attention.py``.  Three GQA
execution paths share the same parameters:

- :func:`gqa_prefill` — causal self-attention over whole prompts through
  the flash-attention kernel (K6), returning the prompt's keys and
  values for the decode cache;
- :func:`gqa_attend` — attention over whole sequences with no cache:
  the Whisper encoder's self-attention (not causal) and the decoder's
  cross-attention (``memory=``: queries from ``x``, keys and values from
  the encoder's output, never causal), through K6;
- :func:`gqa_decode` — single-token decode against the KV cache: the new
  row is written into the cache in place, then attention runs through
  the decode-attention kernel (K5).

The port keeps each layer's KV cache as ``(B, Hkv, S_max, hd)``, the
layout K5 reads; the reference keeps ``(B, S_max, Hkv, hd)``.

MLA (:func:`mla_prefill`, :func:`mla_decode`) compresses keys and values
into a latent ``c_kv`` (B, S, kv_lora_rank) and one decoupled RoPE key
``k_rope`` (B, S, qk_rope_head_dim) shared by every head; its cache keeps
only those two, laid out as the reference's.  The reference computes MLA
attention in plain jnp and calls no kernel, so the port computes it in
plain PyTorch (only its norms go through K4).  Training
(``models.model.forward_train``) runs :func:`gqa_prefill` /
:func:`mla_prefill` and drops their cache rows, as the reference's
``gqa_attend`` computes the same attention.  The GQA functions read
their widths from ``cfg`` and their weights from ``p``, so the
partitioned strategy (:mod:`repro_torch.parallel.partition`) runs them
unchanged on a rank's local heads: a per-rank ``cfg`` with its query and
KV head counts, and ``p`` holding its column blocks of ``wq/wk/wv`` and
row block of ``wo`` (whose partial sums it all-reduces).
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
    "MLA",
    "Rope",
    "Slots",
    "cache_slots",
    "gqa_attend",
    "gqa_decode",
    "gqa_decode_heads",
    "gqa_init_",
    "gqa_prefill",
    "mla_decode",
    "mla_init_",
    "mla_prefill",
    "rope_for",
    "sdpa",
    "write_latent_rows",
    "write_rows",
]

NEG_INF = -1e30

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
    values).  MLA rotates only its ``qk_rope_head_dim`` columns."""
    width = cfg.mla.qk_rope_head_dim if cfg.block_pattern == "mla_moe" else cfg.head_dim_
    return rope_tables(positions, width, cfg.rope_theta)


def _project_qkv(p: GQA, cfg: ModelConfig, x: torch.Tensor, rope: Rope,
                 memory: torch.Tensor | None = None, memory_rope: Rope | None = None,
                 gather=None):
    """Queries from ``x`` roped by ``rope``; keys and values from ``x`` too,
    or from ``memory`` (B, T, d) with the keys roped by ``memory_rope``.
    ``gather`` (q, k, v) -> (q, k, v), where given, makes the projections'
    column blocks whole before they are cut into heads."""
    b, s, _ = x.shape
    h = cfg.head_dim_
    src, src_rope = (x, rope) if memory is None else (memory, memory_rope)
    t = src.shape[1]
    q, k, v = dense(p.wq, x), dense(p.wk, src), dense(p.wv, src)
    if gather is not None:
        q, k, v = gather(q, k, v)
    q = q.reshape(b, s, cfg.n_heads, h)
    k = k.reshape(b, t, cfg.n_kv_heads, h)
    v = v.reshape(b, t, cfg.n_kv_heads, h)
    if cfg.qk_norm:
        q = rmsnorm(p.q_norm, q, cfg.norm_eps)
        k = rmsnorm(p.k_norm, k, cfg.norm_eps)
    return rotate(q, *rope), rotate(k, *src_rope), v


def _attend(p: GQA, cfg: ModelConfig, x: torch.Tensor, rope: Rope, causal: bool,
            memory: torch.Tensor | None = None, memory_rope: Rope | None = None):
    """Project, attend through K6 (never causal over a memory) and apply
    ``wo``: ``(out, k, v)``, with k and v as ``(B, T, Hkv, hd)``."""
    q, k, v = _project_qkv(p, cfg, x, rope, memory, memory_rope)
    out = sdpa(q, k, v, causal=causal and memory is None)
    b, s = x.shape[:2]
    return dense(p.wo, out.reshape(b, s, cfg.n_heads * cfg.head_dim_)), k, v


def gqa_attend(
    p: GQA,
    cfg: ModelConfig,
    x: torch.Tensor,
    rope: Rope,
    *,
    causal: bool,
    memory: torch.Tensor | None = None,
    memory_rope: Rope | None = None,
) -> torch.Tensor:
    """Attention over the whole sequence ``x`` (B, S, d), ``rope`` from
    :func:`rope_for` of its positions: self-attention, or with ``memory``
    (B, T, d) cross-attention, its keys roped by ``memory_rope`` (the
    memory positions' tables) and never causal, as the reference's
    ``gqa_attend(..., memory=)``."""
    return _attend(p, cfg, x, rope, causal, memory, memory_rope)[0]


def gqa_prefill(
    p: GQA, cfg: ModelConfig, x: torch.Tensor, rope: Rope
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefill: full causal attention, ``rope`` from :func:`rope_for` of the
    prompt positions.  Returns the output and the prompt's keys and
    values as ``(B, Hkv, S, hd)`` views."""
    out, k, v = _attend(p, cfg, x, rope, True)
    return out, k.transpose(1, 2), v.transpose(1, 2)


def cache_slots(pos: torch.Tensor, s_max: int) -> Slots:
    """Where :func:`write_rows` writes for positions ``pos`` (B,) in a cache
    of ``s_max`` positions: the sequence index, the clamped position and
    whether the position lies inside the cache (shared by every layer).
    A position may be a shard's local one (``pos - offset``, negative where
    the shard begins past it): it is clamped at 0 too, and writes nothing."""
    bi = torch.arange(pos.shape[0], device=pos.device)
    inside = (pos >= 0) & (pos < s_max)
    return bi, pos.clamp(0, s_max - 1).long(), inside[:, None, None]


def write_rows(cache: torch.Tensor, rows: torch.Tensor, slots: Slots) -> None:
    """``cache[b, :, pos[b]] = rows[b]`` in place, for every sequence b.

    cache: (B, Hkv, S_max, hd); rows: (B, Hkv, hd); slots from
    :func:`cache_slots`.  As the reference's masked write, a position
    outside the cache writes nothing (it is clamped and rewritten with the
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
    out = gqa_decode_heads(p, cfg, x, cache_k, cache_v, pos, rope, slots)
    return dense(p.wo, out.reshape(x.shape[0], 1, cfg.n_heads * cfg.head_dim_))


def gqa_decode_heads(
    p: GQA,
    cfg: ModelConfig,
    x: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    pos: torch.Tensor,
    rope: Rope,
    slots: Slots,
    *,
    gather=None,
    attend=None,
) -> torch.Tensor:
    """:func:`gqa_decode` up to ``wo``: the heads' outputs (B, H, hd).  The
    partitioned decode (:mod:`repro_torch.parallel.partition`) passes
    ``gather`` (:func:`_project_qkv`'s), a shard-local ``pos`` and
    ``slots``, ``rope`` of the global positions, and ``attend`` (q, k, v,
    pos) -> (B, H, hd) in place of K5's whole-cache launch."""
    q, k_new, v_new = _project_qkv(p, cfg, x, rope, gather=gather)
    write_rows(cache_k, k_new[:, 0], slots)
    write_rows(cache_v, v_new[:, 0], slots)
    return (attend or ops.decode_attention)(q[:, 0], cache_k, cache_v, pos)


def write_latent_rows(cache: torch.Tensor, rows: torch.Tensor, slots: Slots) -> None:
    """``cache[b, pos[b]] = rows[b]`` in place, for a cache (B, S_max, r)
    and rows (B, r): :func:`write_rows` for MLA's latent layout."""
    bi, at, inside = slots
    cache[bi, at] = torch.where(inside[:, :, 0], rows.to(cache.dtype), cache[bi, at])


# --------------------------------------------------------------------------
# MLA (DeepSeek-V3): low-rank Q/KV compression with decoupled RoPE.
# The KV cache stores only (c_kv, k_rope).
# --------------------------------------------------------------------------


class MLA(nn.Module):
    """``wq_a``, ``q_a_norm``, ``wq_b``, ``wkv_a``, ``kv_a_norm``,
    ``wkv_b``, ``wo``, as the reference's."""

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        m, dt, d, nh = cfg.mla, cfg.torch_dtype, cfg.d_model, cfg.n_heads
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        kw = dict(bias=False, dtype=dt, device=device)
        self.wq_a = Dense(d, m.q_lora_rank, **kw)
        self.q_a_norm = RMSNorm(m.q_lora_rank, dtype=dt, device=device)
        self.wq_b = Dense(m.q_lora_rank, nh * qk, **kw)
        self.wkv_a = Dense(d, m.kv_lora_rank + m.qk_rope_head_dim, **kw)
        self.kv_a_norm = RMSNorm(m.kv_lora_rank, dtype=dt, device=device)
        self.wkv_b = Dense(m.kv_lora_rank, nh * (m.qk_nope_head_dim + m.v_head_dim), **kw)
        self.wo = Dense(nh * m.v_head_dim, d, **kw)


def mla_init_(p: MLA, generator: torch.Generator) -> None:
    for proj in (p.wq_a, p.wq_b, p.wkv_a, p.wkv_b, p.wo):
        dense_init_(proj, generator)


def _mla_qkv(p: MLA, cfg: ModelConfig, x: torch.Tensor, rope: Rope, gather=None):
    """q_nope (B, S, H, nope), q_rope (B, S, H, rope), c_kv (B, S, r),
    k_rope (B, S, rope).  The low-rank norms take the reference's default
    eps (1e-6), not ``cfg.norm_eps``.  ``gather`` (q,) -> (q,), where
    given, makes ``wq_b`` 's column block whole before it is cut into
    heads (the partitioned decode's, as :func:`_project_qkv` 's)."""
    m = cfg.mla
    b, s, _ = x.shape
    q = dense(p.wq_b, rmsnorm(p.q_a_norm, dense(p.wq_a, x)))
    if gather is not None:
        (q,) = gather(q)
    q = q.reshape(b, s, cfg.n_heads, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    kv_a = dense(p.wkv_a, x)
    c_kv, k_rope = kv_a.split([m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    c_kv = rmsnorm(p.kv_a_norm, c_kv.contiguous())
    k_rope = rotate(k_rope[:, :, None, :], *rope)[:, :, 0, :]
    return q_nope, rotate(q_rope, *rope), c_kv, k_rope


def _mla_attend(p: MLA, cfg: ModelConfig, q_nope, q_rope, c_kv, k_rope, mask):
    """Attention with keys and values expanded from the latent cache;
    ``mask`` (B or 1, S, T) marks the keys each query sees."""
    m = cfg.mla
    b, t = c_kv.shape[:2]
    s, nh = q_nope.shape[1], cfg.n_heads
    kv = dense(p.wkv_b, c_kv).reshape(b, t, nh, m.qk_nope_head_dim + m.v_head_dim)
    k_nope, v = kv.split([m.qk_nope_head_dim, m.v_head_dim], dim=-1)
    logits = (
        torch.einsum("bsnh,btnh->bnst", q_nope, k_nope)
        + torch.einsum("bsnh,bth->bnst", q_rope, k_rope)
    ).float()
    logits.mul_((m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5)
    logits.masked_fill_(~mask[:, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q_nope.dtype)
    del logits
    out = torch.einsum("bnst,btnh->bsnh", probs, v)
    return dense(p.wo, out.reshape(b, s, nh * m.v_head_dim))


def mla_prefill(
    p: MLA, cfg: ModelConfig, x: torch.Tensor, rope: Rope
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefill: causal MLA over the prompt (``rope`` from :func:`rope_for`
    of its positions).  Returns the output, ``c_kv`` (B, S, r) and
    ``k_rope`` (B, S, rope) for the cache."""
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, cfg, x, rope)
    s = x.shape[1]
    i = torch.arange(s, device=x.device)
    causal = (i[:, None] >= i[None, :])[None]
    return _mla_attend(p, cfg, q_nope, q_rope, c_kv, k_rope, causal), c_kv, k_rope


def mla_decode(
    p: MLA,
    cfg: ModelConfig,
    x: torch.Tensor,
    cache_c: torch.Tensor,
    cache_r: torch.Tensor,
    pos: torch.Tensor,
    rope: Rope,
    slots: Slots,
) -> torch.Tensor:
    """One-token decode.  ``cache_c`` (B, S_max, r) / ``cache_r`` (B, S_max,
    rope) are updated in place with this token's latent row at ``pos``
    (B,) (nothing is written past the cache); keys past ``pos`` are
    masked out.  ``rope`` is :func:`rope_for` of ``pos[:, None]`` and
    ``slots`` :func:`cache_slots` of ``pos``."""
    q_nope, q_rope, c_new, r_new = _mla_qkv(p, cfg, x, rope)
    write_latent_rows(cache_c, c_new[:, 0], slots)
    write_latent_rows(cache_r, r_new[:, 0], slots)
    t = cache_c.shape[1]
    valid = torch.arange(t, device=x.device)[None, :] <= pos[:, None]
    return _mla_attend(p, cfg, q_nope, q_rope, cache_c, cache_r, valid[:, None, :])
