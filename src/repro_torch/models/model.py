"""Model assembly: init / train-forward / prefill / decode for the dense,
vlm, moe, mla_moe, mamba2, zamba2 and encdec families.

The port's counterpart of ``repro/models/model.py`` for
``block_pattern`` ``"dense"`` (pre-norm transformer, GQA attention,
SwiGLU FFN), ``"moe"`` (GQA attention + a mixture-of-experts FFN),
``"mla_moe"`` (DeepSeek-style MLA attention + MoE with a shared expert,
and the multi-token-prediction head, which ``forward_train`` runs and
serving never does), ``"mamba2"`` (an attention-free stack of Mamba2
blocks), ``"zamba2"`` (Mamba2 blocks with one *shared* attention + FFN
block applied before every ``hybrid_period`` of them) and ``"vlm"``
(LLaVA: the dense decoder, its input prefixed by the batch's
``patches``, stub vision-tower embeddings (B, P, d)) and ``"encdec"``
(Whisper: a non-causal encoder over the batch's ``frames``, stub conv
frontend embeddings (B, T, d), and a decoder whose layers add
cross-attention to the encoder's output, the *memory*).  A layer's FFN
is the MoE wherever the config has experts, as in the reference.  Entry
points::

    init_params(generator, cfg)                       -> params
    forward_train(params, cfg, batch, remat=True)     -> (logits, aux, mtp_logits)
    prefill(params, cfg, batch, max_len=None)         -> (logits, cache)
    decode_step(params, cfg, tokens, cache)           -> (logits, cache)
    init_decode_cache(params, cfg, batch, max_seq)    -> cache

A batch is ``{"tokens": (B, S) int}`` and, for vlm, ``"patches"``; the
patches come first and positions run over the whole sequence, as in the
reference's ``_embed_inputs``.  For encdec it also holds ``"frames"``;
without them the entry points raise ``KeyError``, as the reference's.

``params`` is the family's module (:data:`FAMILIES`): the embedding
table (also the unembedding's weight, as in the reference), the final
norm, the layers as an ``nn.ModuleList`` and, for zamba2, the shared
block ``shared_attn``; for mla_moe with ``mtp_depth``, ``mtp``; for
encdec, the ``encoder`` (its own ``layers`` and ``final_norm``).  Caches,
every leaf stacked over layers (or over the shared block's uses), with
``"pos"`` (B,) int32 beside them:

- dense, vlm, moe, encdec: ``{"k", "v"}`` ``(L, B, Hkv, S_max, hd)`` — the
  reference stacks ``(L, B, S_max, Hkv, hd)``; encdec's cache also holds
  ``"memory"`` (B, T, d), the encoder's output, beside ``"layers"``;
- mla_moe: ``{"c_kv": (L, B, S_max, kv_lora_rank), "k_rope": (L, B,
  S_max, qk_rope_head_dim)}``, as the reference's;
- mamba2: ``{"conv": (L, B, W-1, C), "ssm": (L, B, H, P, N) fp32}``, as
  the reference's;
- zamba2: ``{"attn": {"k", "v"} (n_super, B, Hkv, S_max, hd), "mamba":
  {"conv", "ssm"} (L, ...)}`` — the reference stacks the Mamba2 state
  ``(n_super, period, ...)``.

:func:`decode_step` writes the step into that cache in place and returns
it with ``pos + 1``; the reference returns a new cache.  Each decode
step projects the memory's keys and values again in every layer, as the
reference's ``_layer_decode`` does.  The decode
path's MoE drops nothing (``no_drop``), the prefill's drops past the
experts' capacity, as the reference's.  Where the reference's
``_ffn_apply`` takes the expert-parallel dispatch, so does the port's
(:func:`_moe_apply`): ``cfg.moe.dispatch == "shard_map"``, not
``no_drop``, an ambient mesh (:func:`repro_torch.parallel.set_mesh`) with
a ``model`` axis whose extent divides the expert count
(:func:`repro_torch.models.moe_sharded.moe_apply_sharded`).  Otherwise it
takes ``moe_apply``, over the whole batch: where the sharded train step
has split the batch over the data axes, the shards' tokens are gathered
first (:func:`~repro_torch.models.moe_sharded.moe_apply_global`), so the
capacity is the global batch's, as under the reference's global arrays.

:func:`forward_train` runs the whole sequence through every layer and
returns the logits of every position (fp32; for vlm the token suffix
only), the MoE load-balance loss summed over layers and, for DeepSeek's
MTP head, the logits predicting token t+2.  It is differentiable: the
kernels it reaches (K4, K6, K7) are entered through their
``torch.autograd.Function`` s (:mod:`repro_torch.kernels.ops`), and
``remat=True`` recomputes each layer in the backward pass
(``torch.utils.checkpoint``), as the reference's ``jax.checkpoint``;
Whisper's encoder layers are recomputed whatever ``remat`` says, as the
reference's ``_encode`` always checkpoints them.  MLA attends in plain
PyTorch, as in serving.

Tensors go on :func:`repro_torch.backend.device` (``cuda`` unless a
``set_backend(device=...)`` scope says otherwise); parameters that lie
elsewhere are refused.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import backend
from ..parallel.constrain import ambient_mesh, batch_axes
from .attention import (
    GQA,
    MLA,
    cache_slots,
    gqa_attend,
    gqa_decode,
    gqa_init_,
    gqa_prefill,
    mla_decode,
    mla_init_,
    mla_prefill,
    rope_for,
)
from .config import ModelConfig
from .ffn import MoE, SwiGLU, moe_apply, moe_init_, swiglu, swiglu_init_
from .layers import (
    Dense,
    Embed,
    RMSNorm,
    _normal,
    embed,
    embed_init_,
    rmsnorm,
    unembed,
)
from .moe_sharded import expert_parallel, moe_apply_global, moe_apply_sharded
from .ssm import Mamba2, mamba2_apply, mamba2_decode, mamba2_init_, mamba2_init_state

__all__ = [
    "DecoderLayer",
    "DenseLM",
    "EncDecLM",
    "Encoder",
    "FAMILIES",
    "LM",
    "MLAMoELM",
    "MTP",
    "Mamba2LM",
    "MambaLayer",
    "MoELM",
    "Zamba2LM",
    "check_family",
    "decode_step",
    "forward_train",
    "init_decode_cache",
    "init_params",
    "params_device",
    "prefill",
]

Cache = dict


class DecoderLayer(nn.Module):
    """``norm1``, ``attn`` (GQA; MLA for mla_moe), ``norm2``, ``ffn``
    (SwiGLU; the MoE where the config has experts) and, for encdec,
    ``norm_x`` and ``cross`` (GQA cross-attention to the memory); also
    zamba2's shared block and Whisper's encoder layers (dense)."""

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        dt = cfg.torch_dtype
        self.norm1 = RMSNorm(cfg.d_model, dtype=dt, device=device)
        if cfg.block_pattern == "mla_moe":
            self.attn = MLA(cfg, device=device)
        else:
            self.attn = GQA(cfg, device=device)
        self.norm2 = RMSNorm(cfg.d_model, dtype=dt, device=device)
        if cfg.moe.n_experts:
            self.ffn = MoE(cfg, device=device)
        else:
            self.ffn = SwiGLU(cfg.d_model, cfg.d_ff, dtype=dt, device=device)
        if cfg.block_pattern == "encdec":
            self.norm_x = RMSNorm(cfg.d_model, dtype=dt, device=device)
            self.cross = GQA(cfg, device=device)


class Encoder(nn.Module):
    """Whisper's encoder: ``layers`` (``n_encoder_layers`` dense
    :class:`DecoderLayer` s, attending without a causal mask) and
    ``final_norm``."""

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        enc_cfg = cfg.scaled(block_pattern="dense")
        self.layers = nn.ModuleList(
            DecoderLayer(enc_cfg, device=device) for _ in range(cfg.n_encoder_layers))
        self.final_norm = RMSNorm(cfg.d_model, dtype=cfg.torch_dtype, device=device)


class MTP(nn.Module):
    """DeepSeek-V3's multi-token prediction head: ``proj`` (2d, d), one
    ``block`` (a decoder layer, not stacked) and ``norm``.  Held so that
    weights carry over; serving never runs it."""

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        dt = cfg.torch_dtype
        self.proj = Dense(2 * cfg.d_model, cfg.d_model, bias=False, dtype=dt, device=device)
        self.block = DecoderLayer(cfg, device=device)
        self.norm = RMSNorm(cfg.d_model, dtype=dt, device=device)


class MambaLayer(nn.Module):
    """``norm1`` and ``mamba`` (a Mamba2 block)."""

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        self.norm1 = RMSNorm(cfg.d_model, dtype=cfg.torch_dtype, device=device)
        self.mamba = Mamba2(cfg, device=device)


class _LM(nn.Module):
    """``embed``, ``final_norm`` and ``layers`` of ``layer`` modules."""

    layer: type[nn.Module]

    def __init__(self, cfg: ModelConfig, *, device):
        check_family(cfg)
        super().__init__()
        dt = cfg.torch_dtype
        self.embed = Embed(cfg.vocab, cfg.d_model, dtype=dt, device=device)
        self.final_norm = RMSNorm(cfg.d_model, dtype=dt, device=device)
        self.layers = nn.ModuleList(self.layer(cfg, device=device) for _ in range(cfg.n_layers))


class DenseLM(_LM):
    """A dense decoder: ``layers`` of :class:`DecoderLayer`."""

    layer = DecoderLayer


class MoELM(_LM):
    """GQA attention + MoE: ``layers`` of :class:`DecoderLayer`."""

    layer = DecoderLayer


class MLAMoELM(_LM):
    """MLA attention + MoE with a shared expert: ``layers`` of
    :class:`DecoderLayer` and, with ``mtp_depth``, ``mtp``."""

    layer = DecoderLayer

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__(cfg, device=device)
        if cfg.mtp_depth:
            self.mtp = MTP(cfg, device=device)


class Mamba2LM(_LM):
    """An attention-free stack: ``layers`` of :class:`MambaLayer`."""

    layer = MambaLayer


class Zamba2LM(_LM):
    """``layers`` of :class:`MambaLayer` and one ``shared_attn``
    (:class:`DecoderLayer`) applied before every ``hybrid_period`` of
    them, with the same weights at every use."""

    layer = MambaLayer

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__(cfg, device=device)
        if cfg.n_layers % cfg.hybrid_period:
            raise ValueError(f"{cfg.name}: n_layers must be a multiple of hybrid_period")
        self.shared_attn = DecoderLayer(cfg, device=device)


class EncDecLM(_LM):
    """Whisper: the ``encoder`` and a decoder of :class:`DecoderLayer` s
    with cross-attention."""

    layer = DecoderLayer

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__(cfg, device=device)
        self.encoder = Encoder(cfg, device=device)


LM = DenseLM | MoELM | MLAMoELM | Mamba2LM | Zamba2LM | EncDecLM
FAMILIES: dict[str, type[_LM]] = {
    "dense": DenseLM,
    "vlm": DenseLM,  # the dense decoder; the patch prefix is input, not weights
    "moe": MoELM,
    "mla_moe": MLAMoELM,
    "mamba2": Mamba2LM,
    "zamba2": Zamba2LM,
    "encdec": EncDecLM,
}


def check_family(cfg: ModelConfig) -> None:
    ssm = cfg.block_pattern in ("mamba2", "zamba2")
    if cfg.block_pattern not in FAMILIES or (cfg.moe.n_experts and ssm):
        raise NotImplementedError(
            f"{cfg.name}: the port runs the {', '.join(FAMILIES)} families, as the "
            f"reference; block_pattern={cfg.block_pattern!r} "
            f"(n_experts={cfg.moe.n_experts}) is not one of them"
        )
    if cfg.block_pattern == "mla_moe" and cfg.mla is None:
        raise ValueError(f"{cfg.name}: block_pattern 'mla_moe' needs an MLAConfig")


@torch.no_grad()
def init_params(generator: torch.Generator, cfg: ModelConfig) -> LM:
    """Random parameters on :func:`backend.device`, drawn from ``generator``
    (which must live on that device) with the reference's rules:
    projections N(0, 1/fan_in) (the MoE router in fp32), the embedding
    and the MTP projection N(0, 0.02²), the conv weight N(0, 0.1²), norms
    and ``D`` one, biases and ``A_log`` zero.  Not the reference's
    numbers: its generator differs."""
    check_family(cfg)
    params = FAMILIES[cfg.block_pattern](cfg, device=backend.device())
    embed_init_(params.embed, generator)
    for layer in params.layers:
        if isinstance(layer, MambaLayer):
            mamba2_init_(layer.mamba, generator)
        else:
            _decoder_init_(layer, generator)
    if isinstance(params, Zamba2LM):
        _decoder_init_(params.shared_attn, generator)
    if isinstance(params, EncDecLM):
        for layer in params.encoder.layers:
            _decoder_init_(layer, generator)
    if hasattr(params, "mtp"):
        _normal(params.mtp.proj.w, 0.02, generator)
        _decoder_init_(params.mtp.block, generator)
    return params


def _decoder_init_(block: DecoderLayer, generator: torch.Generator) -> None:
    if isinstance(block.attn, MLA):
        mla_init_(block.attn, generator)
    else:
        gqa_init_(block.attn, generator)
    if isinstance(block.ffn, MoE):
        moe_init_(block.ffn, generator)
    else:
        swiglu_init_(block.ffn, generator)
    if hasattr(block, "cross"):
        gqa_init_(block.cross, generator)


def params_device(params: LM) -> torch.device:
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


def _empty_kv(cfg: ModelConfig, n: int, batch: int, length: int, device) -> dict:
    """Zeroed attention caches of ``n`` layers (or uses): GQA's keys and
    values, or MLA's latent rows and RoPE keys."""
    dt = cfg.torch_dtype
    if cfg.block_pattern == "mla_moe":
        m = cfg.mla
        return {
            "c_kv": torch.zeros((n, batch, length, m.kv_lora_rank), dtype=dt, device=device),
            "k_rope": torch.zeros((n, batch, length, m.qk_rope_head_dim), dtype=dt,
                                  device=device),
        }
    shape = (n, batch, cfg.n_kv_heads, length, cfg.head_dim_)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
    }


def _kv_len(kv: dict) -> int:
    """S_max of a cache from :func:`_empty_kv`."""
    return kv["c_kv"].shape[2] if "c_kv" in kv else kv["k"].shape[3]


def _empty_ssm(cfg: ModelConfig, batch: int, device) -> dict:
    conv, ssm = mamba2_init_state(cfg, batch, cfg.torch_dtype, device)
    return {
        "conv": conv.new_zeros((cfg.n_layers,) + conv.shape),
        "ssm": ssm.new_zeros((cfg.n_layers,) + ssm.shape),
    }


def _n_super(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.hybrid_period


def _moe_apply(p: MoE, cfg: ModelConfig, x, *, no_drop: bool = False):
    """The MoE FFN, ``(y, aux)``, by the dispatch the reference's
    ``_ffn_apply`` picks under the ambient mesh."""
    mesh = ambient_mesh()
    if expert_parallel(cfg, mesh, no_drop=no_drop):
        return moe_apply_sharded(p, cfg, x, mesh)
    if batch_axes():
        return moe_apply_global(p, cfg, x, mesh, batch_axes(), no_drop=no_drop)
    return moe_apply(p, cfg, x, no_drop=no_drop)


def _ffn(block: DecoderLayer, cfg: ModelConfig, x, *, no_drop: bool = False):
    if isinstance(block.ffn, MoE):
        return _moe_apply(block.ffn, cfg, x, no_drop=no_drop)[0]
    return swiglu(block.ffn, x)


def _cross(block: DecoderLayer, cfg: ModelConfig, x, rope, cross):
    """encdec's ``norm_x`` -> cross-attention residual; ``cross`` is the
    memory and its rope tables, or None (no cross-attention)."""
    if cross is None:
        return x
    memory, memory_rope = cross
    h = rmsnorm(block.norm_x, x, cfg.norm_eps)
    return x + gqa_attend(block.cross, cfg, h, rope, causal=False, memory=memory,
                          memory_rope=memory_rope)


def _attn_ffn_prefill(block: DecoderLayer, cfg: ModelConfig, x, rope, kv: dict, i: int,
                      cross=None):
    """One attention + FFN block over the prompt (with encdec's
    cross-attention between them); writes its cache rows (keys and
    values, or MLA's latent rows) into use ``i`` of ``kv``."""
    s = x.shape[1]
    h = rmsnorm(block.norm1, x, cfg.norm_eps)
    if isinstance(block.attn, MLA):
        h, c_kv, k_rope = mla_prefill(block.attn, cfg, h, rope)
        kv["c_kv"][i, :, :s] = c_kv
        kv["k_rope"][i, :, :s] = k_rope
    else:
        h, k, v = gqa_prefill(block.attn, cfg, h, rope)
        kv["k"][i, :, :, :s] = k
        kv["v"][i, :, :, :s] = v
    x = _cross(block, cfg, x + h, rope, cross)
    h = rmsnorm(block.norm2, x, cfg.norm_eps)
    return x + _ffn(block, cfg, h)


def _attn_ffn_decode(block: DecoderLayer, cfg: ModelConfig, x, kv: dict, i: int, pos,
                     rope, slots, cross=None):
    h = rmsnorm(block.norm1, x, cfg.norm_eps)
    if isinstance(block.attn, MLA):
        h = mla_decode(block.attn, cfg, h, kv["c_kv"][i], kv["k_rope"][i], pos, rope, slots)
    else:
        h = gqa_decode(block.attn, cfg, h, kv["k"][i], kv["v"][i], pos, rope, slots)
    x = _cross(block, cfg, x + h, rope, cross)
    h = rmsnorm(block.norm2, x, cfg.norm_eps)
    return x + _ffn(block, cfg, h, no_drop=True)


def _mamba_prefill(layer: MambaLayer, cfg: ModelConfig, x, state: dict, i: int):
    """One Mamba2 layer over the prompt; writes its final (conv, ssm)
    state into layer ``i`` of ``state``."""
    h, (conv, ssm) = mamba2_apply(layer.mamba, cfg, rmsnorm(layer.norm1, x, cfg.norm_eps))
    state["conv"][i] = conv
    state["ssm"][i] = ssm
    return x + h


def _mamba_decode(layer: MambaLayer, cfg: ModelConfig, x, state: dict, i: int):
    h, (conv, ssm) = mamba2_decode(
        layer.mamba, cfg, rmsnorm(layer.norm1, x, cfg.norm_eps),
        (state["conv"][i], state["ssm"][i]),
    )
    state["conv"][i].copy_(conv)
    state["ssm"][i].copy_(ssm)
    return x + h


def _embed_inputs(params: LM, cfg: ModelConfig, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Token embeddings, after vlm's ``patches`` prefix where the batch has
    one, and the positions (B, S) of the whole sequence."""
    x = embed(params.embed, batch["tokens"])
    if cfg.block_pattern == "vlm" and "patches" in batch:
        x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
    b, s, _ = x.shape
    return x, torch.arange(s, device=x.device)[None, :].expand(b, s)


def _zero_aux(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _memory_rope(cfg: ModelConfig, memory: torch.Tensor):
    """The rope tables of the memory positions ``arange(T)``, shared by the
    encoder's queries and keys and by every cross-attention's keys."""
    return rope_for(cfg, torch.arange(memory.shape[1], device=memory.device)[None, :])


def _encoder_layer(layer: DecoderLayer, cfg: ModelConfig, x: torch.Tensor, rope):
    h = rmsnorm(layer.norm1, x, cfg.norm_eps)
    x = x + gqa_attend(layer.attn, cfg, h, rope, causal=False)
    return x + swiglu(layer.ffn, rmsnorm(layer.norm2, x, cfg.norm_eps))


def _encode(params: EncDecLM, cfg: ModelConfig, frames: torch.Tensor):
    """Whisper's encoder over the stub frame embeddings (B, T, d): the
    memory (B, T, d) and its rope tables.  Each layer is recomputed in the
    backward pass where autograd records, as the reference's
    ``jax.checkpoint(body)``."""
    x = frames.to(params.embed.table.dtype)
    rope = _memory_rope(cfg, x)
    for layer in params.encoder.layers:
        if torch.is_grad_enabled():
            x = checkpoint(_encoder_layer, layer, cfg, x, rope, use_reentrant=False)
        else:
            x = _encoder_layer(layer, cfg, x, rope)
    return rmsnorm(params.encoder.final_norm, x, cfg.norm_eps), rope


def _layer_train(layer: nn.Module, cfg: ModelConfig, x: torch.Tensor, rope, cross=None):
    """One layer over the whole sequence (no cache): ``(x, aux)``, aux the
    MoE load-balance loss (0 elsewhere); ``cross`` as in :func:`_cross`."""
    if isinstance(layer, MambaLayer):
        h, _ = mamba2_apply(layer.mamba, cfg, rmsnorm(layer.norm1, x, cfg.norm_eps))
        return x + h, _zero_aux(x)
    h = rmsnorm(layer.norm1, x, cfg.norm_eps)
    if isinstance(layer.attn, MLA):
        h = mla_prefill(layer.attn, cfg, h, rope)[0]
    else:
        h = gqa_prefill(layer.attn, cfg, h, rope)[0]
    x = _cross(layer, cfg, x + h, rope, cross)
    h = rmsnorm(layer.norm2, x, cfg.norm_eps)
    if isinstance(layer.ffn, MoE):
        h, aux = _moe_apply(layer.ffn, cfg, h)
    else:
        h, aux = swiglu(layer.ffn, h), _zero_aux(x)
    return x + h, aux


def _run_layer(layer, cfg: ModelConfig, x: torch.Tensor, rope, remat: bool, cross=None):
    if remat and torch.is_grad_enabled():
        return checkpoint(_layer_train, layer, cfg, x, rope, cross, use_reentrant=False)
    return _layer_train(layer, cfg, x, rope, cross)


def forward_train(
    params: LM, cfg: ModelConfig, batch: dict, *, remat: bool = True
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """Full forward: ``(logits (B, S, V) fp32, aux, mtp_logits | None)``.

    For vlm the patch prefix is consumed and the logits are the token
    suffix's; for encdec the encoder runs on ``batch["frames"]`` and every
    decoder layer attends to its output; aux is the MoE load-balance loss
    summed over layers (0 without experts); with DeepSeek's MTP head,
    ``mtp_logits`` (B, S - 1,
    V) predict token t+2 from the final hidden state at t and the
    embedding of token t+1.  ``remat`` recomputes each layer in the
    backward pass (the same numbers, less memory)."""
    check_family(cfg)
    params_device(params)
    cross = _encode(params, cfg, batch["frames"]) if cfg.block_pattern == "encdec" else None
    x, positions = _embed_inputs(params, cfg, batch)
    aux = _zero_aux(x)
    rope = None if cfg.block_pattern == "mamba2" else rope_for(cfg, positions)
    for i, layer in enumerate(params.layers):
        if cfg.block_pattern == "zamba2" and i % cfg.hybrid_period == 0:
            x, _ = _run_layer(params.shared_attn, cfg, x, rope, remat)
        x, a = _run_layer(layer, cfg, x, rope, remat, cross)
        aux = aux + a
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    if cfg.block_pattern == "vlm" and "patches" in batch:
        x = x[:, batch["patches"].shape[1]:]
    logits = unembed(params.embed, x)
    if not (cfg.mtp_depth and hasattr(params, "mtp")):
        return logits, aux, None
    # MTP: token t+2 from (hidden_t, embed_{t+1}); its aux is not counted
    mtp = params.mtp
    h = torch.cat([x[:, :-1], embed(params.embed, batch["tokens"])[:, 1:]], dim=-1)
    h, _ = _run_layer(mtp.block, cfg, h @ mtp.proj.w, rope_for(cfg, positions[:, :-1]), remat)
    return logits, aux, unembed(params.embed, rmsnorm(mtp.norm, h, cfg.norm_eps))


def _logits(params: LM, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    # the norm is row-wise: normalising only the last position gives the
    # reference's logits
    x = rmsnorm(params.final_norm, x[:, -1:].contiguous(), cfg.norm_eps)
    return unembed(params.embed, x)


@torch.no_grad()
def prefill(
    params: LM, cfg: ModelConfig, batch: dict, *, max_len: int | None = None
) -> tuple[torch.Tensor, Cache]:
    """Process the prompts ``batch["tokens"]`` (B, S), after vlm's
    ``batch["patches"]`` (B, P, d) where given; returns the last-position
    logits (B, 1, V) fp32 and the decode cache, which holds the prefix's
    rows too.  For encdec the encoder runs on ``batch["frames"]`` first,
    and the cache keeps its output as ``"memory"``.

    ``max_len`` reserves cache headroom for the decode steps that follow
    (default: the prompt length only); the Mamba2 state has none to
    reserve.
    """
    check_family(cfg)
    dev = params_device(params)
    x, positions = _embed_inputs(params, cfg, batch)
    b, s, _ = x.shape
    pos = torch.full((b,), s, dtype=torch.int32, device=dev)
    length = max(s, max_len or 0)
    if cfg.block_pattern == "mamba2":
        state = _empty_ssm(cfg, b, dev)
        for i, layer in enumerate(params.layers):
            x = _mamba_prefill(layer, cfg, x, state, i)
        return _logits(params, cfg, x), {"layers": state, "pos": pos}
    rope = rope_for(cfg, positions)
    if cfg.block_pattern == "zamba2":
        kv = _empty_kv(cfg, _n_super(cfg), b, length, dev)
        state = _empty_ssm(cfg, b, dev)
        for i, layer in enumerate(params.layers):
            if i % cfg.hybrid_period == 0:
                x = _attn_ffn_prefill(params.shared_attn, cfg, x, rope, kv,
                                      i // cfg.hybrid_period)
            x = _mamba_prefill(layer, cfg, x, state, i)
        return _logits(params, cfg, x), {"layers": {"attn": kv, "mamba": state}, "pos": pos}
    kv = _empty_kv(cfg, cfg.n_layers, b, length, dev)
    cache = {"layers": kv, "pos": pos}
    cross = None
    if cfg.block_pattern == "encdec":
        cross = _encode(params, cfg, batch["frames"])
        cache["memory"] = cross[0]
    for i, layer in enumerate(params.layers):
        x = _attn_ffn_prefill(layer, cfg, x, rope, kv, i, cross)
    return _logits(params, cfg, x), cache


@torch.no_grad()
def decode_step(
    params: LM, cfg: ModelConfig, tokens: torch.Tensor, cache: Cache
) -> tuple[torch.Tensor, Cache]:
    """One decode step; ``tokens`` (B, 1); cache from :func:`prefill` or
    :func:`init_decode_cache`.  Writes the step into the cache in place;
    returns the logits (B, 1, V) fp32 and the cache with ``pos + 1``."""
    check_family(cfg)
    params_device(params)
    pos = cache["pos"]
    x = embed(params.embed, tokens)
    layers = cache["layers"]
    if cfg.block_pattern == "mamba2":
        for i, layer in enumerate(params.layers):
            x = _mamba_decode(layer, cfg, x, layers, i)
    else:
        kv = layers["attn"] if cfg.block_pattern == "zamba2" else layers
        rope, slots = rope_for(cfg, pos[:, None]), cache_slots(pos, _kv_len(kv))
        if cfg.block_pattern == "zamba2":
            for i, layer in enumerate(params.layers):
                if i % cfg.hybrid_period == 0:
                    x = _attn_ffn_decode(params.shared_attn, cfg, x, kv,
                                         i // cfg.hybrid_period, pos, rope, slots)
                x = _mamba_decode(layer, cfg, x, layers["mamba"], i)
        else:
            memory = cache.get("memory")
            cross = None if memory is None else (memory, _memory_rope(cfg, memory))
            for i, layer in enumerate(params.layers):
                x = _attn_ffn_decode(layer, cfg, x, kv, i, pos, rope, slots, cross)
    logits = _logits(params, cfg, x)
    new_cache = dict(cache)
    new_cache["pos"] = pos + 1
    return logits, new_cache


def init_decode_cache(params: LM, cfg: ModelConfig, batch: int, max_seq: int) -> Cache:
    """Empty cache; ``pos`` starts at ``max_seq - 1`` to model a
    fully-populated context, as the reference's does; encdec's holds a
    zero memory (B, encoder_seq, d)."""
    check_family(cfg)
    dev = params_device(params)
    pos = torch.full((batch,), max_seq - 1, dtype=torch.int32, device=dev)
    if cfg.block_pattern == "mamba2":
        layers = _empty_ssm(cfg, batch, dev)
    elif cfg.block_pattern == "zamba2":
        layers = {
            "attn": _empty_kv(cfg, _n_super(cfg), batch, max_seq, dev),
            "mamba": _empty_ssm(cfg, batch, dev),
        }
    else:
        layers = _empty_kv(cfg, cfg.n_layers, batch, max_seq, dev)
    cache = {"layers": layers, "pos": pos}
    if cfg.block_pattern == "encdec":
        cache["memory"] = torch.zeros((batch, cfg.encoder_seq, cfg.d_model),
                                      dtype=cfg.torch_dtype, device=dev)
    return cache
