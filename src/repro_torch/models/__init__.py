"""Model zoo of the port: configs + init/prefill/decode of the dense,
mamba2 and zamba2 families."""

from .config import MLAConfig, ModelConfig, MoEConfig, SSMConfig
from .model import (
    LM,
    DenseLM,
    Mamba2LM,
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
    "Mamba2LM",
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "Zamba2LM",
    "decode_step",
    "init_decode_cache",
    "init_params",
    "prefill",
]
