"""Feed-forward layers: SwiGLU.

The port's counterpart of ``repro/models/ffn.py``'s SwiGLU; the
mixture-of-experts layer waits for the MoE slice.
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import Dense, dense, dense_init_

__all__ = ["SwiGLU", "swiglu", "swiglu_init_"]


class SwiGLU(nn.Module):
    """``wi_gate``, ``wi_up`` (d, d_ff) and ``wo`` (d_ff, d)."""

    def __init__(self, d: int, d_ff: int, *, dtype, device):
        super().__init__()
        self.wi_gate = Dense(d, d_ff, bias=False, dtype=dtype, device=device)
        self.wi_up = Dense(d, d_ff, bias=False, dtype=dtype, device=device)
        self.wo = Dense(d_ff, d, bias=False, dtype=dtype, device=device)


def swiglu_init_(p: SwiGLU, generator: torch.Generator) -> None:
    for proj in (p.wi_gate, p.wi_up, p.wo):
        dense_init_(proj, generator)


def swiglu(p: SwiGLU, x: torch.Tensor) -> torch.Tensor:
    g = nn.functional.silu(dense(p.wi_gate, x))
    u = dense(p.wi_up, x)
    return dense(p.wo, g * u)
