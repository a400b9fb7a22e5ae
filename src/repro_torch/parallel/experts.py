"""The expert FFN split on ``model``: the partitioned strategy's MoE layer.

The reference places the experts ``(E, D, F)`` as ``("model", fsdp,
None)`` and the router ``(fsdp, None)``; XLA partitions ``moe_apply``
over that layout.  The port's counterpart (:func:`moe_partitioned`),
called by :class:`repro_torch.parallel.partition.Partitioned` once a
layer, takes the rank's ``E/m`` experts gathered on the data axes (its
``Step`` chain with ``model`` left out), the router gathered there and
used whole, and the layer's input whole on ``model`` (the caller's
``copy_in``); it returns this rank's share of the routed experts' output,
which the caller sums over ``model`` in one ``reduce_out`` with the
shared expert's (column- and row-split like a dense FFN).

Dispatch, by ``cfg.moe.dispatch`` and the step:

- ``"gspmd"`` (train and prefill): the capacity is the *global* batch's,
  ``max(1, int(N_global k / E cf))``, as the single-device step's, so the
  kept set is the same.  Each rank routes its own tokens; the data shards'
  per-expert counts ``(E,)`` are all-gathered, so an assignment's global
  arrival rank is its rank within its shard plus the counts of the shards
  before it (arrival is data-shard-major, as the global batch's rows).
  No token's d-vector crosses the data axes beyond the fixed buffers:
  data rank ``d'`` runs global rows ``[d' C_d, (d'+1) C_d)`` of each of
  its experts (``C_d = ceil(C / dp)``), its ``E/m x C_d`` rows being the
  global ``(E, C, d)`` buffer split over both axes.  The tokens reach it
  in a buffer ``(dp, E/m, C_d + 1, d)`` (a spare row a destination and
  expert, where dropped and other experts' assignments land) summed by a
  reduce-scatter over the data axes (each slot has one writer, so the
  sum is exact), and its outputs come back by the all-gather; fixed
  shapes, so no host sync and countable on ``meta``.
- ``"shard_map"``: the reference's ``moe_apply_sharded`` body: the
  capacity of this rank's data shard, its own experts, no data-axis
  traffic.
- ``no_drop`` (decode): routing is per token, so the rank's tokens, its
  experts and a ``(E/m, N_local + 1, d)`` buffer are exact, with no
  data-axis traffic.

The aux loss (with grad on): under ``"gspmd"`` the Switch loss of the
global batch, the ``(E,)`` counts from the gathered table and the
probability sums all-reduced over the data axes, its gradient the local
tokens' share (the step scales each data shard's loss by the shard
count and averages the gradients); under ``"shard_map"`` the data shards'
local losses averaged, as the reference's.  Where the experts split on
``model`` its gradient counts ``1/m`` on each ``model`` rank, as
``moe_sharded``'s does, since the router's gradient is summed over
``model`` (each rank's combine weights cover its experts only).  With one
data shard and one ``model`` rank every shape and operation is
``moe_apply``'s, so the result is its bit for bit.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.distributed as dist
from torch import nn

from ..models.config import ModelConfig
from ..models.ffn import _count_drops, _positions_in_expert, _top_k
from ..models.layers import dense
from ..models.moe_sharded import _ScaleGrad

__all__ = ["Axis", "moe_partitioned"]

Axis = tuple[Any, int]  # a data axis's process group and extent, major first


def _reduce_scatter(x: torch.Tensor, axes: tuple[Axis, ...]) -> torch.Tensor:
    """The sum over ``axes`` of a flat tensor cut into ``prod(n)`` equal
    parts, this rank's part (the major axis's parts the outer ones)."""
    for group, n in axes:
        out = x.new_empty(x.numel() // n)
        dist.reduce_scatter_tensor(out, x.contiguous(), group=group)
        x = out
    return x


def _all_gather(x: torch.Tensor, axes: tuple[Axis, ...]) -> torch.Tensor:
    """The ranks' flat tensors concatenated in ``axes``' order, major first
    (the minor axis gathered first)."""
    for group, n in reversed(axes):
        out = x.new_empty(n * x.numel())
        dist.all_gather_into_tensor(out, x.contiguous().reshape(-1), group=group)
        x = out
    return x


class _ScatterRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes, ctx.shape = axes, x.shape
        return _reduce_scatter(x.reshape(-1), axes)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.axes).view(ctx.shape), None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes, ctx.shape = axes, x.shape
        return _all_gather(x.reshape(-1), axes)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.axes).view(ctx.shape), None


class _Dispatch(torch.autograd.Function):
    """The tokens ``xs`` (N, d) written into a zero buffer of ``rows``
    rows at ``slot`` (N, k): k writes, never an (N k, d) copy.  The
    backward is ``moe_apply`` 's (its ``repeat_interleave`` and scatter's):
    each assignment's row gathered, then the k summed a token."""

    @staticmethod
    def forward(ctx, xs, slot, rows):
        ctx.save_for_backward(slot)
        send = xs.new_zeros((rows, xs.shape[1]))
        for j in range(slot.shape[1]):
            send.index_put_((slot[:, j],), xs)
        return send

    @staticmethod
    def backward(ctx, g):
        (slot,) = ctx.saved_tensors
        n, k = slot.shape
        return g[slot.reshape(-1)].reshape(n, k, g.shape[1]).sum(dim=1), None, None


def _all_reduce(x: torch.Tensor, axes: tuple[Axis, ...]) -> torch.Tensor:
    x = x.detach().clone()
    for group, _ in axes:
        dist.all_reduce(x, group=group)
    return x


def moe_partitioned(p, cfg: ModelConfig, x: torch.Tensor, *, first: int, e_loc: int, m: int,
                    data: tuple[Axis, ...], index: int, no_drop: bool = False
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """This rank's share of the routed experts' output for ``x`` (B_local,
    S, d), and the aux loss (0 without grad) (module docstring).  ``p``
    holds ``router.w`` (d, E) whole and ``experts`` ``wi_gate`` / ``wi_up``
    (E_local, d, f) and ``wo`` (E_local, f, d), the experts ``[first,
    first + e_loc)``; ``m`` the ``model`` ranks the experts split over (1
    where they do not); ``data`` the data axes the batch's rows split over
    (empty where every rank holds the whole batch), ``index`` this rank's
    data shard."""
    mc = cfg.moe
    b, s, d = x.shape
    n = b * s
    e, k = mc.n_experts, mc.top_k
    dp = math.prod(a[1] for a in data)
    exchange = dp > 1 and mc.dispatch == "gspmd" and not no_drop
    probs = torch.softmax(dense(p.router, x.float()), dim=-1)
    top_w, top_i = _top_k(probs, k)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp(min=1e-9)
    flat_e = top_i.reshape(n * k)
    pos = _positions_in_expert(flat_e, e)
    counts = torch.zeros(e, dtype=torch.int64, device=x.device).index_add_(
        0, flat_e, torch.ones_like(flat_e))
    n_route = n
    if exchange:  # global arrival ranks from the shards' counts
        table = _all_gather(counts, data).view(dp, e)
        offsets = (table.cumsum(0) - table)[index]
        pos = pos + offsets[flat_e]
        counts, n_route = table.sum(0), n * dp
    cap = n if no_drop else max(1, int(n_route * k / e * mc.capacity_factor))
    keep = (pos >= 0) & (pos < cap)
    if not no_drop:
        _count_drops(keep)
    local_e = flat_e - first
    take = keep & (local_e >= 0) & (local_e < e_loc)

    # dispatch: a taken assignment into row pos % C_d of its expert in the
    # buffer of data rank pos // C_d; the rest into a spare row
    parts = dp if exchange else 1
    cd = -(-cap // parts)
    dest = torch.where(take, pos // cd, 0).clamp(0, parts - 1)
    row = torch.where(take, pos - dest * cd, cd).clamp(0, cd)
    ex = torch.where(take, local_e, 0).clamp(0, e_loc - 1)
    slot = ((dest * e_loc + ex) * (cd + 1) + row).view(n, k)
    send = _Dispatch.apply(x.reshape(n, d), slot, parts * e_loc * (cd + 1))
    buf = _ScatterRows.apply(send, data) if exchange else send
    h = buf.view(e_loc, cd + 1, d)[:, :cd]
    w = p.experts
    h = nn.functional.silu(torch.bmm(h, w.wi_gate)) * torch.bmm(h, w.wi_up)
    out = torch.bmm(h, w.wo)  # (E_local, C_d, d)

    # combine: each taken assignment's row back from its data rank, weighted
    if exchange:
        out = _GatherRows.apply(out, data)
    out = out.reshape(-1, d)
    back = torch.where(take, (dest * e_loc + ex) * cd + row, 0).clamp(0, out.shape[0] - 1)
    gathered = out[back] * (top_w.reshape(n * k) * take).to(x.dtype)[:, None]
    y = gathered.reshape(n, k, d).sum(dim=1).reshape(b, s, d)

    if not torch.is_grad_enabled():
        return y, torch.zeros((), dtype=torch.float32, device=x.device)
    frac = counts.float() / (n_route * k)
    if exchange:  # the global mean probability; its gradient the local tokens'
        local = probs.sum(dim=(0, 1))
        mean_prob = (local + (_all_reduce(local, data) - local).detach()) / n_route
    else:
        mean_prob = probs.mean(dim=(0, 1))
    aux = e * torch.sum(frac * mean_prob) * mc.router_aux_coef
    if dp > 1 and not exchange and mc.dispatch == "shard_map":
        # the reference's data shards' estimates averaged
        aux = aux / dp + (_all_reduce(aux, data) / dp - aux / dp).detach()
    if m > 1:
        aux = _ScaleGrad.apply(aux, 1.0 / m)
    return y, aux
