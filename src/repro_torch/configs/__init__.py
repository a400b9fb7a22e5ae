"""Architecture registry: ``get_config(arch_id)`` / ``ARCHS``.

The port's counterpart of ``repro/configs``.  One module per
architecture the port runs; each exports ``CONFIG`` (the exact published
shape) and ``smoke_config()`` (a reduced same-family config for CPU
tests).  The port runs every family of the reference (dense, moe,
mla_moe, mamba2, zamba2, vlm and encdec), so :data:`WAITING`, the
reference's architectures still waiting for a slice, is empty; an arch
listed there would raise a ``KeyError`` that names its slice.
"""

from __future__ import annotations

import importlib

from ..models.config import ModelConfig

__all__ = ["ARCHS", "WAITING", "get_config", "get_smoke_config"]

ARCHS = (
    "qwen2.5-32b",
    "qwen2-72b",
    "qwen3-32b",
    "qwen1.5-4b",
    "qwen3-moe-235b-a22b",
    "deepseek-v3-671b",
    "mamba2-130m",
    "zamba2-2.7b",
    "llava-next-mistral-7b",
    "whisper-medium",
)

# the reference's other architectures, and the slice each waits for: none
WAITING: dict[str, str] = {}

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCHS}


def _module(arch: str):
    if arch in WAITING:
        raise KeyError(
            f"arch {arch!r} is not ported yet: it waits for {WAITING[arch]}"
        )
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCHS}")
    return importlib.import_module(f"{__name__}.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()
