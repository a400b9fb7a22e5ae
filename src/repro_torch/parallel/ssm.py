"""The Mamba2 mixer split on ``model``: the partitioned strategy's SSM layer.

The reference places a Mamba2 block's ``in_proj/w`` ``(D, 2 d_in + 2 N +
H)`` as ``(fsdp, "model")`` (column-split, where ``model`` divides the
columns) and ``out_proj`` ``(d_in, D)`` as ``("model", fsdp)``
(row-split); ``conv_w``, ``conv_b``, ``A_log``, ``D``, ``dt_bias`` and
``norm_g`` are replicated; XLA partitions ``mamba2_apply`` over that
layout.  The port's counterpart, which
:class:`repro_torch.parallel.partition.Partitioned` composes once a
layer with its ``model``-axis operators, takes one of two modes
(:func:`ssm_mode`):

- ``"heads"`` where the SSD heads ``H`` divide the ``model`` extent
  ``m``: rank ``r`` owns heads ``[r H/m, (r+1) H/m)``.  ``in_proj``'s
  column block does not line up with the heads (the packed ``[z, x, B,
  C, dt]`` cut in ``m`` contiguous ranges), so the layer's whole
  ``in_proj`` is gathered over ``model`` (a weight, not the activation)
  and :func:`heads_view` takes the rank's columns: its heads' ``z``, ``x``
  and ``dt``, and ``B`` / ``C`` whole; its ``x`` and the ``B`` / ``C``
  channels of ``conv_w`` / ``conv_b``; its heads of ``A_log``, ``D``,
  ``dt_bias`` and its slice of ``norm_g``.  Every one of these gradients
  is partial on a rank (the ``B`` / ``C`` columns on every rank, the rest
  on one), so each is summed over ``model``.  K7 runs unchanged on the
  rank's ``(B, S, H/m, P)`` with ``B`` / ``C`` whole (the mixer reads its
  widths from these weights, ``models.ssm.mamba2_mix``).  The gated norm
  is one RMSNorm over all of ``d_in``, so its statistic spans the ranks:
  :func:`gated_norm` all-reduces the slices' fp32 sums of squares (its
  backward an all-reduce too: each rank's statistic feeds only its own
  slice) and scales by ``norm_g``'s slice, in plain PyTorch around the
  collective, as ``softmax_combine`` is; with a group of one K4 runs, as
  ``mamba2_apply`` does.  ``out_proj`` 's row block is the rank's heads
  (``y`` is head-major), then ``reduce_out``;
- ``"replicated"`` otherwise (mamba2-130m's 24 heads on 16): the whole
  mixer on every ``model`` rank, ``in_proj`` gathered over ``model`` where
  it splits; where ``out_proj`` splits, its row block takes the rank's
  slice of ``y``, then ``reduce_out`` (every mixer gradient then partial,
  summed over ``model``); where it does not, ``out_proj`` is used whole
  and the gradients are whole (a split ``in_proj``'s sliced back).  The
  SSM counterpart of replicated attention, with its cost.

Decode takes the state ``conv`` / ``ssm`` as ``cache_sharding`` lays
it out: the rows on the data axes, whole on ``model``.  A rank projects
its ``in_proj`` column block (gathered on the data axes only), the
blocks' one-token rows are all-gathered over ``model`` in one call
(:func:`gather_columns`), and every ``model`` rank runs the whole state
update on its copy, which stays replicated on ``model`` (the layout's
cost, as in XLA's).  In ``"heads"`` mode the output ``C h`` is computed
for the rank's heads only, gated by their ``z`` and normalised by
:func:`gated_norm`, then ``out_proj`` 's row block and ``reduce_out``;
else ``y`` whole (K4) and ``out_proj`` as in train.
"""

from __future__ import annotations

import types

import torch
import torch.distributed as dist

from ..models.config import ModelConfig
from ..models.ssm import _dims

__all__ = ["gated_norm", "gather_columns", "heads_view", "ssm_mode"]


def ssm_mode(cfg: ModelConfig, m: int) -> str:
    """``"heads"`` or ``"replicated"`` on a ``model`` extent ``m`` (module
    docstring)."""
    return "heads" if _dims(cfg)[1] % m == 0 else "replicated"


def _spans(t: torch.Tensor, dim: int, spans: list) -> torch.Tensor:
    return torch.cat([t.narrow(dim, lo, n) for lo, n in spans], dim)


def heads_view(p, cfg: ModelConfig, r: int, m: int) -> types.SimpleNamespace:
    """Rank ``r`` 's mixer weights in ``"heads"`` mode, from ``p`` holding
    the whole ``in_proj`` and the replicated weights, and ``out_proj`` 's
    row block (module docstring)."""
    d_in, nh, _, st = _dims(cfg)
    w, h = d_in // m, nh // m
    lo, first = r * w, r * h
    conv = [(lo, w), (d_in, 2 * st)]  # its x channels, then B and C
    proj = [(lo, w), (d_in + lo, w), (2 * d_in, 2 * st), (2 * d_in + 2 * st + first, h)]
    return types.SimpleNamespace(
        in_proj=types.SimpleNamespace(w=_spans(p.in_proj.w, 1, proj), b=None),
        conv_w=_spans(p.conv_w, 1, conv), conv_b=_spans(p.conv_b, 0, conv),
        A_log=p.A_log.narrow(0, first, h), D=p.D.narrow(0, first, h),
        dt_bias=p.dt_bias.narrow(0, first, h), norm_g=p.norm_g.narrow(0, lo, w),
        out_proj=p.out_proj)


class _SumOver(torch.autograd.Function):
    """The ranks' partial sums all-reduced; the gradient all-reduced too,
    since every rank's result feeds that rank's computation only."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def gated_norm(y: torch.Tensor, g: torch.Tensor, eps: float, *, group,
               width: int) -> torch.Tensor:
    """RMSNorm of ``y`` (..., d_in/m), a slice of rows ``width`` wide
    split over ``group``: K4's function (fp32 math, ``x * rsqrt(mean(x²)
    + eps) * g``, cast back) with the mean over the whole row, its sum of
    squares all-reduced."""
    yf = y.float()
    total = _SumOver.apply((yf * yf).sum(-1, keepdim=True), group)
    return (yf * torch.rsqrt(total / width + eps) * g.float()).to(y.dtype)


def gather_columns(t: torch.Tensor, group, m: int) -> torch.Tensor:
    """``t`` (..., c), this rank's column block of a projection's rows,
    made whole (..., m c) by one all-gather over ``group``, rank-major."""
    local = t.contiguous()
    buf = local.new_empty((m * local.shape[0],) + tuple(local.shape[1:]))
    dist.all_gather_into_tensor(buf, local, group=group)
    buf = buf.view(m, *local.shape).movedim(0, -2)  # (..., m, c)
    return buf.reshape(*local.shape[:-1], m * local.shape[-1])
