"""Model zoo of the port: configs + init/train-forward/prefill/decode of
the dense, vlm, moe, mla_moe, mamba2 and zamba2 families."""

from .config import MLAConfig, ModelConfig, MoEConfig, SSMConfig
from .model import (
    LM,
    DenseLM,
    Mamba2LM,
    MLAMoELM,
    MoELM,
    Zamba2LM,
    decode_step,
    forward_train,
    init_decode_cache,
    init_params,
    prefill,
)

__all__ = [
    "LM",
    "DenseLM",
    "MLAConfig",
    "MLAMoELM",
    "Mamba2LM",
    "ModelConfig",
    "MoEConfig",
    "MoELM",
    "SSMConfig",
    "Zamba2LM",
    "decode_step",
    "forward_train",
    "init_decode_cache",
    "init_params",
    "prefill",
]
