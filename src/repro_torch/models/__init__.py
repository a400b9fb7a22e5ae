"""Model zoo of the port: configs + init/prefill/decode of the dense,
moe, mla_moe, mamba2 and zamba2 families."""

from .config import MLAConfig, ModelConfig, MoEConfig, SSMConfig
from .model import (
    LM,
    DenseLM,
    Mamba2LM,
    MLAMoELM,
    MoELM,
    Zamba2LM,
    decode_step,
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
    "init_decode_cache",
    "init_params",
    "prefill",
]
