"""Zamba2-2.7B [hybrid] — 54 Mamba2 layers d_model=2560, shared attention
block (32H kv=32, d_ff=10240) every 6 layers, ssm_state=64, vocab=32000.
[arXiv:2411.15242; hf]"""

from ..models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    block_pattern="zamba2",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab=32000,
    hybrid_period=6,
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_width=4, chunk=256),
)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=256, hybrid_period=2,
        ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, conv_width=4, chunk=32),
        dtype="float32",
    )
