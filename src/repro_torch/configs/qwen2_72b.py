"""Qwen2-72B [dense] — 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064, QKV bias.  [arXiv:2407.10671; hf]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b",
    block_pattern="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=160, vocab=256, dtype="float32",
    )
