"""Expert-parallel MoE dispatch on ``torch.distributed``.

The port's counterpart of ``repro/models/moe_sharded.py``.  With the
experts split on the ``model`` axis and the tokens replicated over it
within each data shard, dispatch needs no communication: every rank
holds the tokens of its data shard and the weights of its experts.  Each
rank (SPMD, plain tensors):

  1. routes its data shard's tokens (the router is replicated), with the
     port's ``_top_k`` (ties to the lower expert) and
     ``_positions_in_expert``;
  2. keeps only the assignments to its own experts (``rank_on("model") *
     E/TP`` onwards), with the per-data-shard capacity ``max(1,
     int(n_loc * k / E * cf))``;
  3. runs its experts on an ``(E/TP, C, d)`` buffer and scatters the
     outputs back to its tokens;
  4. merges the k expert owners' contributions with one ``all_reduce``
     over ``model``;
  5. takes the aux loss locally, averaged over the data shards, and adds
     the shared expert after the merge.

The reference gathers each rank's expert slice over the data axes inside
``shard_map``.  The port's gathered train step (:mod:`repro_torch.train.
step`) gathers every parameter at the start of the step, so a rank's
expert slice is a view of the gathered tensors here; the partitioned
step, which the rule picks for the MoE families, runs the same body on
the slice its per-layer gather gives
(:mod:`repro_torch.parallel.experts`).

Gradients, under the sharded step's conventions (the data axes average
their ranks' gradients; every rank of the ``model`` axis must end with
the whole gradient of each replicated parameter): the tokens enter the
experts, and the router logits the routing, through an identity whose
backward sums over ``model`` (each rank holds only its experts' share);
the merge is an ``all_reduce`` whose backward is the identity (the loss
downstream is the same on every ``model`` rank); the aux loss, the same
on every ``model`` rank, counts 1/TP of its gradient on each; the mean
over the data shards has an identity backward.  A rank's expert weights
get the gradient of its slice only, zero elsewhere.

:func:`moe_apply_global` is the default (``"gspmd"``) dispatch under a
batch split over the data axes: it gathers the shards' tokens (backward:
their gradients summed back to their shard) and routes the whole batch
with ``moe_apply``'s global capacity, as the reference's global arrays do.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch import nn

from ..parallel.constrain import batch_axes
from ..parallel.sharding import fsdp_axes, mesh_sizes
from .config import ModelConfig
from .ffn import MoE, _positions_in_expert, _top_k, moe_apply, swiglu
from .layers import dense

__all__ = ["expert_parallel", "moe_apply_global", "moe_apply_sharded", "moe_route_sharded"]


def expert_parallel(cfg: ModelConfig, mesh, *, no_drop: bool = False) -> bool:
    """Whether the MoE takes the expert-parallel dispatch, as the
    reference's ``_ffn_apply`` decides: ``dispatch == "shard_map"``, not
    ``no_drop``, a mesh with a ``model`` axis whose extent divides the
    expert count."""
    return bool(cfg.moe.n_experts and cfg.moe.dispatch == "shard_map" and not no_drop
                and mesh is not None and "model" in mesh.mesh_dim_names
                and cfg.moe.n_experts % mesh_sizes(mesh)["model"] == 0)


class _SumGrad(torch.autograd.Function):
    """Identity; the backward sums the gradient over ``group``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _SumOut(torch.autograd.Function):
    """``all_reduce`` (sum) over ``group``; the backward is the identity."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _MeanOut(torch.autograd.Function):
    """Mean over ``group``; the backward is the identity (the data axes
    average their ranks' gradients afterwards)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out / dist.get_world_size(group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScaleGrad(torch.autograd.Function):
    """Identity; the backward scales the gradient by ``factor``."""

    @staticmethod
    def forward(ctx, x, factor):
        ctx.factor = factor
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.factor, None


class _Gather(torch.autograd.Function):
    """Concatenate the ranks' blocks along dim 0 in ``group``'s order; the
    backward sums the gradient over ``group`` and keeps this rank's block."""

    @staticmethod
    def forward(ctx, x, group, index):
        ctx.group, ctx.index, ctx.rows = group, index, x.shape[0]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g[ctx.index * ctx.rows:(ctx.index + 1) * ctx.rows], None, None


def moe_apply_global(p: MoE, cfg: ModelConfig, x: torch.Tensor, mesh,
                     axes: tuple[str, ...], *, no_drop: bool = False):
    """``moe_apply`` over the whole batch when ``x`` (B_loc, S, d) is this
    rank's block of a batch split on ``axes`` (major first): the blocks
    gathered, routed with the global capacity, this rank's rows of the
    output returned, and the aux loss of the whole batch."""
    index, stride = 0, 1
    for ax in reversed(axes):  # the minor axis first: blocks land major-first
        x = _Gather.apply(x, mesh.get_group(ax), mesh.get_local_rank(ax))
        index += mesh.get_local_rank(ax) * stride
        stride *= mesh_sizes(mesh)[ax]
    y, aux = moe_apply(p, cfg, x, no_drop=no_drop)
    rows = y.shape[0] // stride
    return y[index * rows:(index + 1) * rows], aux


def _route(cfg: ModelConfig, probs: torch.Tensor, first: int, e_loc: int) -> dict:
    """Top-k routing of ``probs`` (N, E) and the assignments this rank
    keeps: its experts ``[first, first + e_loc)``, within the capacity."""
    m = cfg.moe
    n, e = probs.shape
    k = m.top_k
    cap = max(1, int(n * k / e * m.capacity_factor))
    top_w, top_i = _top_k(probs, k)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp(min=1e-9)
    flat_e = top_i.reshape(n * k)
    pos = _positions_in_expert(flat_e, e)
    local_e = flat_e - first
    mine = (local_e >= 0) & (local_e < e_loc)
    return {"probs": probs, "flat_e": flat_e, "flat_w": top_w.reshape(n * k), "pos": pos,
            "local_e": local_e, "mine": mine, "keep": mine & (pos < cap), "cap": cap}


def _expert_range(cfg: ModelConfig, mesh) -> tuple[int, int]:
    e, tp = cfg.moe.n_experts, mesh_sizes(mesh)["model"]
    if e % tp:
        raise ValueError(f"{e} experts do not divide the model axis of {tp}")
    return mesh.get_local_rank("model") * (e // tp), e // tp


def moe_route_sharded(p: MoE, cfg: ModelConfig, x: torch.Tensor, mesh) -> dict:
    """This rank's routing of its tokens x (B_loc, S, d): ``probs`` (N, E),
    per assignment (N * k) its expert ``flat_e``, weight ``flat_w``,
    arrival rank ``pos``, ``mine`` (one of this rank's experts) and
    ``keep`` (mine and within the per-data-shard capacity ``cap``)."""
    first, e_loc = _expert_range(cfg, mesh)
    probs = torch.softmax(dense(p.router, x.reshape(-1, x.shape[-1]).float()), dim=-1)
    return _route(cfg, probs, first, e_loc)


def moe_apply_sharded(p: MoE, cfg: ModelConfig, x: torch.Tensor, mesh
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Drop-in for ``moe_apply`` under an ambient mesh with a ``model``
    axis: x (B_loc, S, d) is this rank's block of a batch split on the data
    axes (the whole batch where there are none of extent above 1);
    returns this rank's output block and the aux loss (the same on every
    rank)."""
    dp = fsdp_axes(mesh)
    sizes = mesh_sizes(mesh)
    if math.prod(sizes[a] for a in dp) > 1 and batch_axes() != dp:
        raise ValueError(f"the expert-parallel dispatch takes this rank's block of a batch "
                         f"split on {dp}; the batch is split on {batch_axes()}")
    first, e_loc = _expert_range(cfg, mesh)
    tp = sizes["model"]
    group = mesh.get_group("model")
    b, s, d = x.shape
    n = b * s
    k = cfg.moe.top_k
    logits = _SumGrad.apply(dense(p.router, x.reshape(n, d).float()), group)
    r = _route(cfg, torch.softmax(logits, dim=-1), first, e_loc)
    keep, pos, cap = r["keep"], r["pos"], r["cap"]
    dest = torch.where(keep, r["local_e"], 0)

    # dispatch this rank's kept assignments into its experts' rows; the
    # rest into a spare row `cap` that no expert reads
    x_rep = _SumGrad.apply(x, group).reshape(n, d).repeat_interleave(k, dim=0)
    buf = x.new_zeros((e_loc, cap + 1, d))
    buf[dest, torch.where(keep, pos, cap)] = x_rep
    ex = p.experts
    h = buf[:, :cap]
    h = nn.functional.silu(torch.bmm(h, ex.wi_gate[first:first + e_loc])) \
        * torch.bmm(h, ex.wi_up[first:first + e_loc])
    out_buf = torch.bmm(h, ex.wo[first:first + e_loc])

    gathered = out_buf[dest, torch.where(keep, pos, 0)]
    gathered = gathered * (r["flat_w"] * keep).to(x.dtype)[:, None]
    y = _SumOut.apply(gathered.reshape(n, k, d).sum(dim=1), group).reshape(b, s, d)

    e = cfg.moe.n_experts
    ones = torch.ones(n * k, dtype=torch.float32, device=x.device)
    frac = torch.zeros(e, dtype=torch.float32, device=x.device).index_add_(0, r["flat_e"], ones)
    aux = e * torch.sum(frac / (n * k) * r["probs"].mean(dim=0)) * cfg.moe.router_aux_coef
    aux = _ScaleGrad.apply(aux, 1.0 / tp)
    for ax in dp:
        aux = _MeanOut.apply(aux, mesh.get_group(ax))
    if hasattr(p, "shared"):
        y = y + swiglu(p.shared, x)
    return y, aux
