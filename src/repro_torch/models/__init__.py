"""Model zoo of the port: configs + init/prefill/decode of the dense family."""

from .config import MLAConfig, ModelConfig, MoEConfig, SSMConfig
from .model import (
    DenseLM,
    decode_step,
    init_decode_cache,
    init_params,
    prefill,
)

__all__ = [
    "DenseLM",
    "MLAConfig",
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "decode_step",
    "init_decode_cache",
    "init_params",
    "prefill",
]
