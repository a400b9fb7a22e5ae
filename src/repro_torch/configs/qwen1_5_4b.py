"""Qwen1.5-4B [dense] — 40L d_model=2560 20H (MHA kv=20) d_ff=6912
vocab=151936, QKV bias.  [hf:Qwen/Qwen1.5 family; hf]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    block_pattern="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    head_dim=128,
    d_ff=6912,
    vocab=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=160, vocab=256, dtype="float32",
    )
