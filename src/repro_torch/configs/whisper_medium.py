"""Whisper-medium [audio] — enc-dec, 24L encoder + 24L decoder,
d_model=1024 16H (MHA kv=16) d_ff=4096 vocab=51865; conv frontend
STUBBED (the batch supplies ``frames``, 1500 frame embeddings a
sequence).  [arXiv:2212.04356; unverified]

The port's copy of ``repro/configs/whisper_medium.py``.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    block_pattern="encdec",
    n_layers=24,
    n_encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab=51865,
    encoder_seq=1500,
)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(
        n_layers=2, n_encoder_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, vocab=256, encoder_seq=32, dtype="float32",
    )
