"""Qwen3-MoE-235B-A22B [moe] — 94L d_model=4096 64H (GQA kv=4) d_ff=1536
vocab=151936, 128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B family; hf]"""

from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    block_pattern="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=12288,  # dense d_ff unused (all layers MoE); kept for family API
    vocab=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    moe=MoEConfig(n_experts=128, n_shared=0, top_k=8, d_ff_expert=1536),
)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab=256,
        moe=MoEConfig(
            n_experts=8, n_shared=0, top_k=2, d_ff_expert=32,
            capacity_factor=4.0,  # loose: keeps smoke tests drop-free
        ),
        dtype="float32",
    )
