"""Mamba2 (SSD — state-space duality) block.

The port's counterpart of ``repro/models/ssm.py``.  A full-sequence
forward (:func:`mamba2_apply`) runs the chunked SSD scan through the
scan kernel (K7, :func:`repro_torch.kernels.ops.ssd_scan`); a
single-token decode (:func:`mamba2_decode`) is the O(1) recurrence on
(conv_state, ssm_state).  The gated norm goes through the RMSNorm kernel
(K4).  Parameters live in :class:`Mamba2`, named as the reference's
tree; ``A_log``, ``D`` and ``dt_bias`` stay float32.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ..kernels import ops
from .config import ModelConfig
from .layers import Dense, _frozen, _normal, dense, dense_init_

__all__ = [
    "Mamba2",
    "mamba2_apply",
    "mamba2_decode",
    "mamba2_init_",
    "mamba2_init_state",
    "ssd_chunked",
]

State = tuple[torch.Tensor, torch.Tensor]  # conv (B, W-1, C), ssm (B, H, P, N) fp32


def _dims(cfg: ModelConfig) -> tuple[int, int, int, int]:
    s = cfg.ssm
    assert s is not None
    d_in = s.expand * cfg.d_model
    nh = s.n_heads or d_in // s.head_dim
    return d_in, nh, s.head_dim, s.state_dim


class Mamba2(nn.Module):
    """``in_proj`` (packs z, x, B, C, dt), ``conv_w``/``conv_b`` (depthwise
    causal conv over x, B, C), ``A_log``/``D``/``dt_bias`` (fp32),
    ``norm_g`` (the gated norm) and ``out_proj`` (d_in, d)."""

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        d_in, nh, _, st = _dims(cfg)
        dt, f32 = cfg.torch_dtype, torch.float32
        conv_ch = d_in + 2 * st
        width = cfg.ssm.conv_width
        self.in_proj = Dense(cfg.d_model, 2 * d_in + 2 * st + nh, bias=False, dtype=dt,
                             device=device)
        self.conv_w = _frozen(torch.empty(width, conv_ch, dtype=dt, device=device))
        self.conv_b = _frozen(torch.zeros(conv_ch, dtype=dt, device=device))
        self.A_log = _frozen(torch.zeros(nh, dtype=f32, device=device))
        self.D = _frozen(torch.ones(nh, dtype=f32, device=device))
        self.dt_bias = _frozen(torch.zeros(nh, dtype=f32, device=device))
        self.norm_g = _frozen(torch.ones(d_in, dtype=dt, device=device))
        self.out_proj = _frozen(torch.empty(d_in, cfg.d_model, dtype=dt, device=device))


@torch.no_grad()
def mamba2_init_(p: Mamba2, generator: torch.Generator) -> None:
    """The reference's rules: projections N(0, 1/fan_in), the conv weight
    N(0, 0.1²), ``A_log``/``dt_bias``/``conv_b`` zero, ``D``/``norm_g`` one."""
    dense_init_(p.in_proj, generator)
    _normal(p.conv_w, 0.1, generator)
    _normal(p.out_proj, p.out_proj.shape[0] ** -0.5, generator)
    p.conv_b.zero_()
    p.A_log.zero_()
    p.D.fill_(1.0)
    p.dt_bias.zero_()
    p.norm_g.fill_(1.0)


def ssd_chunked(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    chunk: int,
    h0: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan through K7; returns (y (B,S,H,P) fp32, final state
    (B,H,P,N) fp32).  ``chunk`` is the plain version's (CPU tensors).

    The scan is linear in its initial state, so a given ``h0`` (no caller
    on the serving path passes one) adds its decayed contribution to the
    kernel's zero-state result: ``exp(cum_t)·(C_t·h0ᵀ)`` to ``y`` and
    ``exp(cum_S)·h0`` to the final state, with ``cum`` the running sum of
    ``dt·A`` over the whole sequence."""
    y, h_last = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    if h0 is not None:
        h0 = h0.float()
        decay = torch.exp(torch.cumsum(dt * A[None, None, :], dim=1))  # (B, S, H)
        y = y + torch.einsum("bsn,bsh,bhpn->bshp", Cm.float(), decay, h0)
        h_last = h_last + decay[:, -1, :, None, None] * h0
    return y, h_last


def _conv_causal(seq: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv; seq (B, S, C), w (W, C): the reference's
    shifted-sum form, in the same order."""
    width, s = w.shape[0], seq.shape[1]
    pad = F.pad(seq, (0, 0, width - 1, 0))
    out = sum(pad[:, i : i + s, :] * w[i][None, None, :] for i in range(width))
    return out + b[None, None, :]


def _split_proj(p: Mamba2, cfg: ModelConfig, u: torch.Tensor):
    d_in, _, _, st = _dims(cfg)
    zxbcdt = dense(p.in_proj, u)
    return torch.split(zxbcdt, [d_in, d_in + 2 * st, zxbcdt.shape[-1] - 2 * d_in - 2 * st],
                       dim=-1)


def _gate_norm_out(p: Mamba2, cfg: ModelConfig, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """``y`` (fp32, with the D skip) → model dtype, gated by silu(z), the
    gated norm (K4), the output projection."""
    y = y.to(z.dtype) * F.silu(z)
    y = ops.rmsnorm_fused(y, p.norm_g, eps=cfg.norm_eps)
    return y @ p.out_proj


def mamba2_apply(
    p: Mamba2, cfg: ModelConfig, u: torch.Tensor, state: State | None = None
) -> tuple[torch.Tensor, State]:
    """Full-sequence forward; returns (y, (conv_state, ssm_state))."""
    d_in, nh, hd, st = _dims(cfg)
    width = cfg.ssm.conv_width
    b, s, _ = u.shape
    z, xbc, dt_raw = _split_proj(p, cfg, u)
    if state is not None:
        conv_full = torch.cat([state[0], xbc], dim=1)
        conv = _conv_causal(conv_full, p.conv_w, p.conv_b)[:, -s:, :]
    else:
        conv = _conv_causal(xbc, p.conv_w, p.conv_b)
    conv = F.silu(conv)
    xpart, bpart, cpart = torch.split(conv, [d_in, st, st], dim=-1)
    x = xpart.reshape(b, s, nh, hd)  # a view: K7 reads it through its strides
    dt = F.softplus(dt_raw.float() + p.dt_bias[None, None, :])
    A = -torch.exp(p.A_log)
    h0 = state[1] if state is not None else None
    y, h_last = ssd_chunked(x, dt, A, bpart, cpart, cfg.ssm.chunk, h0)
    y = y + x.float() * p.D[None, None, :, None]
    out = _gate_norm_out(p, cfg, y.reshape(b, s, d_in), z)
    prefix = (
        state[0]
        if state is not None
        else xbc.new_zeros(b, width - 1, xbc.shape[-1])
    )
    new_conv_state = torch.cat([prefix, xbc], dim=1)[:, -(width - 1):, :]
    return out, (new_conv_state, h_last)


def mamba2_init_state(cfg: ModelConfig, batch: int, dtype, device) -> State:
    d_in, nh, hd, st = _dims(cfg)
    conv_ch = d_in + 2 * st
    return (
        torch.zeros(batch, cfg.ssm.conv_width - 1, conv_ch, dtype=dtype, device=device),
        torch.zeros(batch, nh, hd, st, dtype=torch.float32, device=device),
    )


def mamba2_decode(
    p: Mamba2, cfg: ModelConfig, u: torch.Tensor, state: State
) -> tuple[torch.Tensor, State]:
    """O(1) single-token step; ``u`` (B, 1, d).  Returns the output and
    the new (conv_state, ssm_state); the caller writes them into its
    cache."""
    d_in, nh, hd, st = _dims(cfg)
    b = u.shape[0]
    z, xbc, dt_raw = _split_proj(p, cfg, u)
    conv_state, h = state
    window = torch.cat([conv_state, xbc], dim=1)  # (B, W, C)
    conv = (window * p.conv_w[None, :, :]).sum(dim=1) + p.conv_b
    conv = F.silu(conv)
    xpart, bpart, cpart = torch.split(conv, [d_in, st, st], dim=-1)
    x = xpart.reshape(b, nh, hd)
    dt = F.softplus(dt_raw[:, 0].float() + p.dt_bias[None, :])
    A = -torch.exp(p.A_log)
    da = torch.exp(dt * A[None, :])  # (B, H)
    xd = x.float() * dt[..., None]
    h_new = h * da[..., None, None] + xd[..., None] * bpart.float()[:, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", h_new, cpart.float()) + x.float() * p.D[None, :, None]
    out = _gate_norm_out(p, cfg, y.reshape(b, 1, d_in), z)
    return out, (window[:, 1:, :], h_new)
