"""Model assembly for the dense family: init / prefill / decode.

The port's counterpart of ``repro/models/model.py`` for
``block_pattern == "dense"`` (pre-norm transformer, GQA attention,
SwiGLU FFN).  Entry points::

    init_params(generator, cfg)                       -> params
    prefill(params, cfg, batch, max_len=None)         -> (logits, cache)
    decode_step(params, cfg, tokens, cache)           -> (logits, cache)
    init_decode_cache(params, cfg, batch, max_seq)    -> cache

``params`` is a :class:`DenseLM` module: the embedding table (also the
unembedding's weight, as in the reference), the final norm, and the
decoder layers as an ``nn.ModuleList``.  The cache is
``{"layers": {"k": ..., "v": ...}, "pos": (B,) int32}`` with ``k``/``v``
stacked over layers as ``(L, B, Hkv, S_max, hd)`` — the reference stacks
``(L, B, S_max, Hkv, hd)``.  :func:`decode_step` writes the new rows
into that cache in place and returns it with ``pos + 1``; the reference
returns a new cache.

Tensors go on :func:`repro_torch.backend.device` (``cuda`` unless a
``set_backend(device=...)`` scope says otherwise); parameters that lie
elsewhere are refused.  Other families, and ``forward_train``, wait for
later slices.
"""

from __future__ import annotations

import torch
from torch import nn

from .. import backend
from .attention import (
    GQA,
    cache_slots,
    gqa_decode,
    gqa_init_,
    gqa_prefill,
    rope_for,
)
from .config import ModelConfig
from .ffn import SwiGLU, swiglu, swiglu_init_
from .layers import Embed, RMSNorm, embed, embed_init_, rmsnorm, unembed

__all__ = [
    "DecoderLayer",
    "DenseLM",
    "check_family",
    "decode_step",
    "init_decode_cache",
    "init_params",
    "params_device",
    "prefill",
]

Cache = dict


def check_family(cfg: ModelConfig) -> None:
    if cfg.block_pattern != "dense" or cfg.moe.n_experts:
        raise NotImplementedError(
            f"{cfg.name}: the port runs the dense family so far; "
            f"block_pattern={cfg.block_pattern!r} (n_experts={cfg.moe.n_experts}) "
            f"waits for a later slice"
        )


class DecoderLayer(nn.Module):
    """``norm1``, ``attn`` (GQA), ``norm2``, ``ffn`` (SwiGLU)."""

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        dt = cfg.torch_dtype
        self.norm1 = RMSNorm(cfg.d_model, dtype=dt, device=device)
        self.attn = GQA(cfg, device=device)
        self.norm2 = RMSNorm(cfg.d_model, dtype=dt, device=device)
        self.ffn = SwiGLU(cfg.d_model, cfg.d_ff, dtype=dt, device=device)


class DenseLM(nn.Module):
    """``embed``, ``final_norm`` and ``layers`` of a dense decoder."""

    def __init__(self, cfg: ModelConfig, *, device):
        check_family(cfg)
        super().__init__()
        dt = cfg.torch_dtype
        self.embed = Embed(cfg.vocab, cfg.d_model, dtype=dt, device=device)
        self.final_norm = RMSNorm(cfg.d_model, dtype=dt, device=device)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, device=device) for _ in range(cfg.n_layers)
        )


@torch.no_grad()
def init_params(generator: torch.Generator, cfg: ModelConfig) -> DenseLM:
    """Random parameters on :func:`backend.device`, drawn from ``generator``
    (which must live on that device) with the reference's rules:
    projections N(0, 1/fan_in), the embedding N(0, 0.02²), norms one,
    biases zero.  Not the reference's numbers: its generator differs."""
    params = DenseLM(cfg, device=backend.device())
    embed_init_(params.embed, generator)
    for layer in params.layers:
        gqa_init_(layer.attn, generator)
        swiglu_init_(layer.ffn, generator)
    return params


def params_device(params: DenseLM) -> torch.device:
    """The parameters' device; raises unless it is :func:`backend.device`'s
    type, so an entry point never runs where the caller did not ask."""
    dev = params.embed.table.device
    want = backend.device()
    if dev.type != want.type:
        raise ValueError(
            f"parameters lie on {dev} but the device in scope is {want}: "
            f"move them, or scope the call with set_backend(device={dev.type!r})"
        )
    return dev


def _empty_kv(cfg: ModelConfig, batch: int, length: int, device) -> dict:
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, length, cfg.head_dim_)
    return {
        "k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
    }


@torch.no_grad()
def prefill(
    params: DenseLM, cfg: ModelConfig, batch: dict, *, max_len: int | None = None
) -> tuple[torch.Tensor, Cache]:
    """Process the prompts ``batch["tokens"]`` (B, S); returns the
    last-position logits (B, 1, V) fp32 and the decode cache.

    ``max_len`` reserves cache headroom for the decode steps that follow
    (default: the prompt length only).
    """
    check_family(cfg)
    dev = params_device(params)
    tokens = batch["tokens"]
    x = embed(params.embed, tokens)
    b, s, _ = x.shape
    positions = torch.arange(s, device=dev)[None, :].expand(b, s)
    rope = rope_for(cfg, positions)
    kv = _empty_kv(cfg, b, max(s, max_len or 0), dev)
    for i, layer in enumerate(params.layers):
        h = rmsnorm(layer.norm1, x, cfg.norm_eps)
        h, k, v = gqa_prefill(layer.attn, cfg, h, rope)
        kv["k"][i, :, :, :s] = k
        kv["v"][i, :, :, :s] = v
        x = x + h
        h = rmsnorm(layer.norm2, x, cfg.norm_eps)
        x = x + swiglu(layer.ffn, h)
    # the norm is row-wise: normalising only the last position gives the
    # reference's logits
    x = rmsnorm(params.final_norm, x[:, -1:].contiguous(), cfg.norm_eps)
    logits = unembed(params.embed, x)
    pos = torch.full((b,), s, dtype=torch.int32, device=dev)
    return logits, {"layers": kv, "pos": pos}


@torch.no_grad()
def decode_step(
    params: DenseLM, cfg: ModelConfig, tokens: torch.Tensor, cache: Cache
) -> tuple[torch.Tensor, Cache]:
    """One decode step; ``tokens`` (B, 1); cache from :func:`prefill` or
    :func:`init_decode_cache`.  Writes the step's rows into the cache in
    place; returns the logits (B, 1, V) fp32 and the cache with
    ``pos + 1``."""
    check_family(cfg)
    params_device(params)
    pos = cache["pos"]
    kc, vc = cache["layers"]["k"], cache["layers"]["v"]
    rope, slots = rope_for(cfg, pos[:, None]), cache_slots(pos, kc.shape[3])
    x = embed(params.embed, tokens)
    for i, layer in enumerate(params.layers):
        h = rmsnorm(layer.norm1, x, cfg.norm_eps)
        x = x + gqa_decode(layer.attn, cfg, h, kc[i], vc[i], pos, rope, slots)
        h = rmsnorm(layer.norm2, x, cfg.norm_eps)
        x = x + swiglu(layer.ffn, h)
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    logits = unembed(params.embed, x)
    new_cache = dict(cache)
    new_cache["pos"] = pos + 1
    return logits, new_cache


def init_decode_cache(
    params: DenseLM, cfg: ModelConfig, batch: int, max_seq: int
) -> Cache:
    """Empty cache; ``pos`` starts at ``max_seq - 1`` to model a
    fully-populated context, as the reference's does."""
    check_family(cfg)
    dev = params_device(params)
    pos = torch.full((batch,), max_seq - 1, dtype=torch.int32, device=dev)
    return {"layers": _empty_kv(cfg, batch, max_seq, dev), "pos": pos}
