"""Assigned input shapes (same four for every LM-family architecture).

The port's copy of ``repro/configs/shapes.py``.  ``train_*`` runs the
train step; ``prefill_*`` the prefill path; ``decode_*`` / ``long_*``
one decode step (one new token against a populated KV cache of
``seq_len``).  ``long_500k`` requires a sub-quadratic path and only runs
for SSM/hybrid archs (DESIGN.md §4).
"""

from __future__ import annotations

import dataclasses

from ..models.config import ModelConfig

__all__ = ["SHAPES", "ShapeSpec", "applicable", "get_shape"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = (
    ShapeSpec("train_4k", "train", 4_096, 256),
    ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    ShapeSpec("decode_32k", "decode", 32_768, 128),
    ShapeSpec("long_500k", "decode", 524_288, 1),
)


def get_shape(name: str) -> ShapeSpec:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) for an (arch, shape) cell."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, "full-attention arch: 500k decode is quadratic-cost; skipped per DESIGN.md §4"
    return True, ""
