"""Qwen3-32B [dense] — 64L d_model=5120 64H (GQA kv=8) d_ff=25600
vocab=151936, qk_norm.  [hf:Qwen/Qwen3 family; hf]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    block_pattern="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=160, vocab=256, dtype="float32",
    )
