"""Mamba2-130M [ssm] — 24L d_model=768, attention-free SSD,
ssm_state=128, vocab=50280.  [arXiv:2405.21060; unverified]"""

from ..models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    block_pattern="mamba2",
    n_layers=24,
    d_model=768,
    n_heads=24,  # unused (attention-free); kept for API uniformity
    n_kv_heads=24,
    head_dim=64,
    d_ff=0,
    vocab=50280,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4, chunk=256),
)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(
        n_layers=2, d_model=64, vocab=256,
        ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, conv_width=4, chunk=32),
        dtype="float32",
    )
