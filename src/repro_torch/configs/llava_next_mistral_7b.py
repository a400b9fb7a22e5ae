"""LLaVA-NeXT-Mistral-7B [vlm] — Mistral-7B backbone: 32L d_model=4096
32H (GQA kv=8) d_ff=14336 vocab=32000; anyres vision tower STUBBED
(the batch supplies ``patches``, 576 patch embeddings a sequence).
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]

The port's copy of ``repro/configs/llava_next_mistral_7b.py``.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    block_pattern="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=32000,
    rope_theta=1_000_000.0,
    n_patches=576,
)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=160, vocab=256, n_patches=16, dtype="float32",
    )
