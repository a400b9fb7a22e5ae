"""Checks the model kernels' wrappers share: device and dtype.

The float kernels (RMSNorm, decode and flash attention) take float32 or
bfloat16 tensors; :data:`DTYPES` maps each to the code their C entry
points take.
"""

from __future__ import annotations

import torch

__all__ = ["DTYPES", "check_device", "check_dtype"]

DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_device(name: str, *tensors: torch.Tensor) -> str:
    """The tensors' common device type, ``"cpu"`` or ``"cuda"``; raises on
    a mix, on another device type, and on a CUDA tensor that is not on
    the current device."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: inputs lie on different devices")
    if dev.type == "cuda":
        if dev.index != torch.cuda.current_device():
            raise ValueError(
                f"{name}: tensors on {dev} but the current device is "
                f"cuda:{torch.cuda.current_device()}"
            )
    elif dev.type != "cpu":
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev.type


def check_dtype(name: str, *tensors: torch.Tensor) -> int:
    """The kernel's dtype code of the tensors' common dtype."""
    dtype = tensors[0].dtype
    if dtype not in DTYPES or any(t.dtype != dtype for t in tensors):
        raise TypeError(
            f"{name}: inputs must share one dtype of {sorted(map(str, DTYPES))}, "
            f"got {[str(t.dtype) for t in tensors]}"
        )
    return DTYPES[dtype]
