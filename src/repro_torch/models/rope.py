"""Rotary position embeddings (GPT-NeoX / Llama convention).

A copy of ``repro/models/rope.py``: split-halves pairs, fp32 math, the
result cast back to the input dtype.  :func:`rope_tables` and
:func:`rotate` split :func:`apply_rope` in two, so a model step computes
the tables once for every layer, query and key.
"""

from __future__ import annotations

import torch

__all__ = ["apply_rope", "rope_freqs", "rope_tables", "rotate"]


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies for even head dims; (head_dim // 2,) fp32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exponent)


def rope_tables(
    positions: torch.Tensor, head_dim: int, theta: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """cos and sin of the rotation angles, (..., S, 1, head_dim / 2) fp32,
    for positions (..., S)."""
    inv = rope_freqs(head_dim, theta, positions.device)
    ang = positions[..., :, None].float() * inv  # (..., S, hd/2)
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate pairs of x (..., S, H, head_dim) by tables from :func:`rope_tables`."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(
    x: torch.Tensor, positions: torch.Tensor, theta: float = 10_000.0
) -> torch.Tensor:
    """Rotate pairs; x: (..., S, H, head_dim), positions: (..., S)."""
    return rotate(x, *rope_tables(positions, x.shape[-1], theta))
