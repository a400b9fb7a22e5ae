"""Feed-forward layers: SwiGLU and mixture-of-experts.

The port's counterpart of ``repro/models/ffn.py``.  MoE follows the
DeepSeek/Qwen3 recipe: an fp32 softmax router, top-k routed experts
(+ optional always-on shared experts), the Switch-style aux
load-balance loss.  Dispatch is capacity-based scatter/gather: tokens are
scattered into an ``(E, C, d)`` buffer, the experts run as one batched
product over the expert axis, and the outputs gather back with the
combine weights.  Which assignments are kept equals the reference's bit
for bit: the top-k puts the lower expert first on ties (as
``jax.lax.top_k``), and each assignment's arrival rank within its expert
comes from a stable sort.  The reference runs no kernel here (plain
einsums), so neither does the port.  The expert-parallel dispatch under
a mesh is :mod:`repro_torch.models.moe_sharded`.
"""

from __future__ import annotations

import torch
from torch import nn

from .config import ModelConfig
from .layers import Dense, _frozen, _normal, dense, dense_init_

__all__ = [
    "MoE",
    "SwiGLU",
    "drop_counts",
    "moe_apply",
    "moe_init_",
    "moe_route",
    "reset_drop_counts",
    "swiglu",
    "swiglu_init_",
]


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


class Experts(nn.Module):
    """The routed experts' weights as bare tensors, as the reference keeps
    them: ``wi_gate``, ``wi_up`` (E, d, f) and ``wo`` (E, f, d)."""

    def __init__(self, e: int, d: int, f: int, *, dtype, device):
        super().__init__()
        self.wi_gate = _frozen(torch.empty(e, d, f, dtype=dtype, device=device))
        self.wi_up = _frozen(torch.empty(e, d, f, dtype=dtype, device=device))
        self.wo = _frozen(torch.empty(e, f, d, dtype=dtype, device=device))


class MoE(nn.Module):
    """``router`` (d, E) fp32, ``experts`` and, with ``n_shared``, the
    shared expert ``shared`` (a SwiGLU of width ``n_shared * f``)."""

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        m, dt, d = cfg.moe, cfg.torch_dtype, cfg.d_model
        self.router = Dense(d, m.n_experts, bias=False, dtype=torch.float32, device=device)
        self.experts = Experts(m.n_experts, d, m.d_ff_expert, dtype=dt, device=device)
        if m.n_shared:
            self.shared = SwiGLU(d, m.d_ff_expert * m.n_shared, dtype=dt, device=device)


@torch.no_grad()
def moe_init_(p: MoE, generator: torch.Generator) -> None:
    """The reference's rules: every projection N(0, 1/fan_in), the fan-in
    of an expert tensor its second-to-last axis.  An expert tensor is
    drawn one expert at a time, so the fp32 noise never spans all E."""
    dense_init_(p.router, generator)
    for w in (p.experts.wi_gate, p.experts.wi_up, p.experts.wo):
        for e in range(w.shape[0]):
            _normal(w[e], w.shape[-2] ** -0.5, generator)
    if hasattr(p, "shared"):
        swiglu_init_(p.shared, generator)


def _top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, ties broken toward the lower
    index (``jax.lax.top_k``'s order; ``torch.topk`` promises none)."""
    values, index = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], index[..., :k]


def _positions_in_expert(flat_e: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Arrival rank of each routed assignment within its expert: sort the
    assignments by expert id (stable), subtract each expert run's start
    offset, unsort."""
    nk = flat_e.shape[0]
    sorted_e, sort_idx = torch.sort(flat_e, stable=True)
    experts = torch.arange(n_experts, device=flat_e.device, dtype=sorted_e.dtype)
    run_start = torch.searchsorted(sorted_e, experts)
    pos_sorted = torch.arange(nk, device=flat_e.device) - run_start[sorted_e]
    return torch.empty_like(pos_sorted).scatter_(0, sort_idx, pos_sorted)


def moe_route(p: MoE, cfg: ModelConfig, x: torch.Tensor, *, no_drop: bool = False) -> dict:
    """The router's decisions for x (B, S, d): ``probs`` (B, S, E) fp32,
    ``top_w``/``top_i`` (B, S, k) (weights renormalised), ``pos`` (N·k,)
    each assignment's arrival rank within its expert, ``keep`` (N·k,)
    ``pos < cap`` and the capacity ``cap`` (``N`` with ``no_drop``)."""
    m = cfg.moe
    b, s, _ = x.shape
    n = b * s
    e, k = m.n_experts, m.top_k
    cap = n if no_drop else max(1, int(n * k / e * m.capacity_factor))
    probs = torch.softmax(dense(p.router, x.float()), dim=-1)
    top_w, top_i = _top_k(probs, k)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp(min=1e-9)
    pos = _positions_in_expert(top_i.reshape(n * k), e)
    return {"probs": probs, "top_w": top_w, "top_i": top_i, "pos": pos, "keep": pos < cap,
            "cap": cap}


# assignments routed and dropped by capacity since reset_drop_counts();
# the dropped count stays a device tensor (no host sync on the model path)
_DROPS: dict = {"routed": 0, "dropped": None}


def drop_counts() -> dict[str, int]:
    """Routed assignments and those dropped past their expert's capacity,
    over every ``moe_apply`` since :func:`reset_drop_counts` (reads the
    device count: a host sync)."""
    dropped = _DROPS["dropped"]
    return {"routed": _DROPS["routed"], "dropped": 0 if dropped is None else int(dropped)}


def reset_drop_counts() -> None:
    _DROPS.update(routed=0, dropped=None)


def _count_drops(keep: torch.Tensor) -> None:
    dropped = (~keep).sum()
    prev = _DROPS["dropped"]
    _DROPS["dropped"] = dropped if prev is None or prev.device != dropped.device else prev + dropped
    _DROPS["routed"] += keep.numel()


def moe_apply(
    p: MoE, cfg: ModelConfig, x: torch.Tensor, *, no_drop: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B, S, d), aux load-balance loss).

    ``no_drop=True`` sizes the expert buffers so that no assignment can
    overflow (``cap = N``): the decode path, where dropping a token's
    expert output would corrupt generation.  A dropped assignment adds
    nothing to its token's output, as in the reference.
    """
    m = cfg.moe
    b, s, d = x.shape
    n = b * s
    e, k = m.n_experts, m.top_k
    r = moe_route(p, cfg, x, no_drop=no_drop)
    keep, pos, cap = r["keep"], r["pos"], r["cap"]
    if not no_drop:
        _count_drops(keep)
    flat_e = r["top_i"].reshape(n * k)
    flat_w = r["top_w"].reshape(n * k)

    # dispatch: a kept assignment into its expert's row `pos`; a dropped one
    # into a spare row `cap` that no expert reads
    x_rep = x.reshape(n, d).repeat_interleave(k, dim=0)  # (N·K, d)
    buf = x.new_zeros((e, cap + 1, d))
    buf[flat_e, torch.where(keep, pos, cap)] = x_rep
    ex = p.experts
    h = buf[:, :cap]
    h = nn.functional.silu(torch.bmm(h, ex.wi_gate)) * torch.bmm(h, ex.wi_up)
    out_buf = torch.bmm(h, ex.wo)  # (E, cap, d)

    # combine: gather back and weight (a dropped assignment's weight is 0)
    gathered = out_buf[flat_e, torch.where(keep, pos, 0)]
    gathered = gathered * (flat_w * keep).to(x.dtype)[:, None]
    y = gathered.reshape(n, k, d).sum(dim=1).reshape(b, s, d)
    if hasattr(p, "shared"):
        y = y + swiglu(p.shared, x)

    # Switch-style aux loss: E · Σ_e fraction_e · mean_prob_e
    ones = torch.ones(n * k, dtype=torch.float32, device=x.device)
    frac = torch.zeros(e, dtype=torch.float32, device=x.device).index_add_(0, flat_e, ones)
    frac = frac / (n * k)  # (index_add_, not bincount: no host sync on the card)
    mean_prob = r["probs"].mean(dim=(0, 1))
    aux = e * torch.sum(frac * mean_prob) * m.router_aux_coef
    return y, aux
