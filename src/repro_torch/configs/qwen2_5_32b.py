"""Qwen2.5-32B [dense] — 64L d_model=5120 40H (GQA kv=8) d_ff=27648
vocab=152064, QKV bias.  [hf:Qwen/Qwen2.5 family; hf]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    block_pattern="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=27648,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=160, vocab=256, dtype="float32",
    )
