"""Model configuration: one dataclass covering all assigned families.

A copy of ``repro/models/config.py`` with :attr:`ModelConfig.torch_dtype`
in place of ``jnp_dtype``.  The port runs the ``dense``, ``mamba2``
and ``zamba2`` families so far; the other families' fields are kept so
every config carries over as data.

Families (``block_pattern``):
- ``dense``    — pre-norm transformer, GQA attention + SwiGLU FFN
- ``moe``      — dense attention + mixture-of-experts FFN (shared + routed)
- ``mla_moe``  — DeepSeek-style MLA attention + MoE FFN (+ optional MTP)
- ``mamba2``   — attention-free SSD (state-space duality) stack
- ``zamba2``   — Mamba2 backbone with a *shared* attention block applied
                 every ``hybrid_period`` layers
- ``encdec``   — Whisper-style encoder-decoder (conv frontend stubbed)
- ``vlm``      — LLaVA-style: LM backbone consuming prefix patch embeddings
                 (vision tower stubbed)
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import torch

BlockPattern = Literal[
    "dense", "moe", "mla_moe", "mamba2", "zamba2", "encdec", "vlm"
]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    n_shared: int = 0  # always-on shared experts (DeepSeek)
    top_k: int = 0
    d_ff_expert: int = 0
    router_aux_coef: float = 0.001
    capacity_factor: float = 1.25
    # "gspmd": scatter a global (E, C, d) buffer, GSPMD inserts comms
    # "shard_map": zero-comm dispatch + psum over `model` (§Perf)
    dispatch: str = "gspmd"
    # serving-time replica balancing (the paper's WF; DESIGN.md §2)
    replicas: int = 1


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 multi-head latent attention dims."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 SSD block dims."""

    state_dim: int = 128
    head_dim: int = 64
    n_heads: int = 0  # 0 → derived: d_inner // head_dim
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    block_pattern: BlockPattern
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 → d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    moe: MoEConfig = MoEConfig()
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    hybrid_period: int = 6  # zamba2: shared attn block every N mamba layers
    # encoder-decoder (whisper)
    n_encoder_layers: int = 0
    encoder_seq: int = 1500  # frame positions after the (stubbed) conv frontend
    # vlm
    n_patches: int = 576  # stub patch-embedding prefix length (llava anyres base)
    # multi-token prediction (deepseek-v3)
    mtp_depth: int = 0
    dtype: str = "bfloat16"

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        dtype = getattr(torch, self.dtype, None)
        if not isinstance(dtype, torch.dtype):
            raise ValueError(f"{self.name}: unknown dtype {self.dtype!r}")
        return dtype

    @property
    def is_attention_free(self) -> bool:
        return self.block_pattern == "mamba2"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic path exists (SSM / hybrid)."""
        return self.block_pattern in ("mamba2", "zamba2")

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs autoregress (whisper via its decoder)

    def scaled(self, **overrides) -> "ModelConfig":
        """Reduced config of the same family (for smoke tests)."""
        return dataclasses.replace(self, **overrides)

    def param_count(self) -> int:
        """Analytic parameter count (used for roofline MODEL_FLOPS)."""
        d, v, L = self.d_model, self.vocab, self.n_layers
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        h = self.head_dim_
        if self.block_pattern in ("dense", "moe", "vlm"):
            qkv = d * (self.n_heads * h) + 2 * d * (self.n_kv_heads * h)
            out = self.n_heads * h * d
            per_layer += qkv + out
        if self.block_pattern == "mla_moe":
            m = self.mla
            assert m is not None
            per_layer += d * m.q_lora_rank + m.q_lora_rank * self.n_heads * (
                m.qk_nope_head_dim + m.qk_rope_head_dim
            )
            per_layer += d * (m.kv_lora_rank + m.qk_rope_head_dim)
            per_layer += m.kv_lora_rank * self.n_heads * (
                m.qk_nope_head_dim + m.v_head_dim
            )
            per_layer += self.n_heads * m.v_head_dim * d
        if self.block_pattern in ("mamba2", "zamba2"):
            s = self.ssm
            assert s is not None
            d_in = s.expand * d
            nh = s.n_heads or d_in // s.head_dim
            per_layer += d * (2 * d_in + 2 * s.state_dim + nh) + d_in * d
            per_layer += s.conv_width * (d_in + 2 * s.state_dim)
        if self.moe.n_experts > 0:
            dense_ff = 3 * d * self.moe.d_ff_expert
            per_layer += (self.moe.n_experts + self.moe.n_shared) * dense_ff
            per_layer += d * self.moe.n_experts  # router
        elif self.block_pattern not in ("mamba2", "zamba2"):
            # zamba2's mamba layers have no FFN; the shared block's FFN
            # is added once below
            per_layer += 3 * d * self.d_ff
        per_layer += 2 * d  # norms
        total = emb + L * per_layer
        if self.block_pattern == "zamba2":
            # one shared attention block (+ its FFN), reused across layers
            qkv = d * (self.n_heads * h) + 2 * d * (self.n_kv_heads * h)
            total += qkv + self.n_heads * h * d + 3 * d * self.d_ff
        if self.n_encoder_layers:
            qkv = d * (self.n_heads * h) + 2 * d * (self.n_kv_heads * h)
            enc_layer = qkv + self.n_heads * h * d + 3 * d * self.d_ff + 2 * d
            # decoder cross-attention adds another attention block per layer
            total += self.n_encoder_layers * enc_layer + L * (qkv + self.n_heads * h * d)
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k + shared experts only)."""
        if self.moe.n_experts == 0:
            return self.param_count()
        full = self.param_count()
        dense_ff = 3 * self.d_model * self.moe.d_ff_expert
        inactive = (
            self.n_layers
            * (self.moe.n_experts - self.moe.top_k)
            * dense_ff
        )
        return int(full - inactive)
