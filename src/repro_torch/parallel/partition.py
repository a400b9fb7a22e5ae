"""The partitioned strategy: the dense decoder's, the MoE families' and
the Mamba2 and Zamba2 families' train, prefill and decode steps split
over the mesh as XLA's SPMD partitioner splits the reference's.

The reference jits its step with ``in_shardings=param_sharding(...)``,
pins the hidden state to ``(dp, None, None)`` at block boundaries and the
logits to ``(dp, None, "model")``, and runs its layers under ``lax.scan``
with ``jax.checkpoint``; XLA then gathers each layer's FSDP blocks inside
the scan body and splits every projection's work over ``model``.  This
module is the port's counterpart, written SPMD on ``torch.distributed``
for the (family, kind) pairs :func:`strategy` sends here
(:data:`PARTITIONED_STEPS`: ``dense``, ``vlm``'s dense decoder, ``moe``,
``mla_moe``, ``mamba2`` and ``zamba2``, each train, prefill and decode);
Whisper's keep the ``"gathered"`` strategy (``train/step.py``,
``launch/specs.py``), which gathers the whole model, and so does a decode
over a cache whose K/V leaves hold their head_dim on ``model``
(:func:`decode_strategy`).

Operators over the ``model`` group (each the identity for a group of one
or ``None``):

- :func:`copy_in` — identity forward, all-reduce of the gradient;
- :func:`reduce_out` — all-reduce forward, identity backward;
- :func:`vocab_embed` — the embedding lookup of a rank's vocabulary
  rows (zero elsewhere), then :func:`reduce_out`;
- :func:`vocab_xent` — the per-token cross-entropy of logits split on
  the vocabulary: the max and the sum of exponentials all-reduced, the
  target's logit from the rank that holds it; its backward needs no
  collective;
- :func:`softmax_combine` — the ranks' partial attention over their
  shards of a cache split by the sequence (K5's partial mode, or MLA's
  plain partial attention: each head's normalised output and
  log-sum-exp) made whole: the log-sum-exps' max all-reduced, then the
  outputs' and the weights' sums in one all-reduce; no backward (decode
  runs under ``no_grad``).

The per-layer gather (:func:`use`): a parameter's local ``DTensor`` block
becomes the tensor the rank computes with by a chain of
:class:`Step` s, one per mesh axis: an all-gather on the dim the axis
splits (backward: a reduce-scatter, averaged over the data axes, summed
or sliced over ``model``), or, on an axis that replicates the
parameter, the identity (backward: an all-reduce where the ranks' grads
are partial, or nothing).  So each gradient arrives at its block
already reduced.  :class:`Partitioned` calls it inside the function that
``torch.utils.checkpoint`` recomputes, so a layer's weights are gathered
again in the backward, as the reference's ``jax.checkpoint(body)``; no
full-model gather remains.

Layouts on a rank: the hidden state (B_local, S, d) whole on ``model``;
``wq/wk/wv`` (and biases) column-parallel, ``wo`` row-parallel then
:func:`reduce_out`, both FFN halves likewise; the embedding table and the
logits split on the vocabulary.  An MoE layer's FFN
(:func:`repro_torch.parallel.experts.moe_partitioned`) takes the rank's
``E/m`` experts, gathered on the data axes only, and the router gathered
there and used whole (its gradient summed over ``model``: each rank's
combine weights cover its own experts); the shared expert is split as a
dense FFN, and the routed and shared outputs meet in one
:func:`reduce_out`.  Attention in train and prefill takes one of two
modes (:func:`attention_mode`):

- ``"heads"`` where ``n_heads`` divides by the ``model`` extent and the
  KV heads split evenly over it or it over them: the rank attends over
  its ``n_heads / m`` query heads with the KV heads they use, under a
  per-rank config (``dataclasses.replace(cfg, n_heads=..., n_kv_heads=...)``),
  so the model functions (``gqa_prefill``, ``mla_prefill``, ``swiglu``)
  run unchanged on local widths.  Where KV heads are fewer than ``m`` (8
  on 16), ``wk/wv`` are gathered over ``model`` and the rank takes the
  head its queries use; their gradients are reduce-scattered back
  (summed: two ranks share a head).  MLA's low-rank path (``wq_a``,
  ``q_a_norm``, ``wkv_a``, ``kv_a_norm``, the rotated ``k_rope``) runs
  whole on every ``model`` rank, its gradients summed over ``model``;
  the rank's column blocks of ``wq_b`` / ``wkv_b`` give its heads' ``q``,
  ``k_nope`` and ``v``;
- ``"replicated"`` otherwise (qwen1.5-4b's 20 heads on 16): the
  projections ``model`` splits gathered over it, attention computed
  whole on every ``model`` rank, their gradients sliced back; FFN and
  vocabulary stay split.

A Mamba2 layer (:mod:`repro_torch.parallel.ssm`) takes its SSD heads
on ``model`` where they divide it (``"heads"``: ``in_proj`` gathered over
``model`` for the layer and cut to the rank's columns, the gated norm's
statistic all-reduced, ``out_proj`` row-parallel) or runs its mixer whole
on every ``model`` rank (``"replicated"``).  Zamba2's shared attention +
FFN block is a decoder layer under the rules above, its parameters
gathered (and their gradients reduced) once a use, inside each use's
recomputed function; autograd sums the uses' gradients.

The train step's loss adds the MoE aux loss (the global batch's Switch
loss under ``"gspmd"``) and DeepSeek's MTP head: its block runs as one
more partitioned layer, ``mtp/proj`` gathered on the data axes and used
whole, its logits split on the vocabulary.

Decode (:meth:`Partitioned.decode`) takes the reference's
``cache_sharding`` blocks as they lie, ``pos`` replicated, the rows on
the data axes (or whole, where they do not divide them), the K/V blocks
in one of the layouts :class:`KVLayout` names:

- the sequence on ``model`` (rank ``r`` holds positions ``[r S/m, (r+1)
  S/m)``): every rank attends all H heads over its own positions.  Each
  layer's weights are gathered on the data axes only; a rank projects its
  column block of ``wq/wk/wv`` (and biases; MLA's ``wq_b``) and the
  blocks' one-token rows are all-gathered over ``model`` in one call (a
  block ``_fit`` left whole is used whole).  RoPE and the per-head norms
  run on the whole rows.  The new K/V (MLA: latent) row is written by the
  masked write at the shard-local position ``pos - r S/m`` (nothing where
  it falls outside the shard); K5's partial mode attends over the shard
  (MLA: ``wkv_b`` gathered over ``model`` for the layer expands the
  shard's latent rows to every head, and a plain partial attention
  returns each head's output and log-sum-exp, ``-inf`` where the shard
  holds no key), and :func:`softmax_combine` makes the heads whole; then
  ``wo`` row-parallel on the rank's column slice;
- the KV heads on ``model`` (the sequence does not divide it): a rank
  projects its heads' column blocks (no gather), writes their new row,
  runs K5's whole-cache mode over them and ``wo`` 's row block, then
  :func:`reduce_out`;
- the KV heads on ``model`` and the sequence on ``data`` (the rows, whole,
  do not divide the data axes: Zamba2's long_500k): the same, the row
  written where ``pos`` falls in the rank's data shard, K5's partial mode
  and :func:`softmax_combine` over the ``data`` group;
- nothing on ``model`` (neither divides it): the rows made whole as in
  the first, K5's whole-cache mode over every head.

Then the FFN (an MoE's per-token ``no_drop`` form over the rank's
experts) and the vocabulary as in train.  A Mamba2 layer's state is
whole on ``model``: the projection's rows all-gathered over ``model``,
every rank runs the whole recurrence on its copy (:mod:`.ssm`).  With a
``model`` group of one it launches K5's whole-cache mode (MLA:
``mla_decode`` over the whole cache; Mamba2: ``mamba2_decode``) and is
``models.decode_step`` bit for bit.
"""

from __future__ import annotations

import dataclasses
import functools
import operator
import types
from typing import Any

import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard
from torch.utils.checkpoint import checkpoint

from ..kernels import ops
from ..models.attention import (_mla_qkv, cache_slots, gqa_decode_heads, gqa_prefill,
                                mla_decode, mla_prefill, rope_for, write_latent_rows)
from ..models.config import ModelConfig
from ..models.ffn import swiglu
from ..models.layers import dense, rmsnorm
from ..models.model import FAMILIES, _zero_aux
from ..models.ssm import mamba2_apply, mamba2_decode, mamba2_decode_mix, mamba2_mix
from .experts import moe_partitioned
from .sharding import (_spec_leaves, data_shard, fsdp_axes, mesh_sizes, param_sharding,
                       placements)
from .ssm import gated_norm, gather_columns, heads_view, ssm_mode

__all__ = [
    "GATHERED",
    "KVLayout",
    "PARTITIONED",
    "PARTITIONED_STEPS",
    "Partitioned",
    "Step",
    "attention_mode",
    "copy_in",
    "decode_strategy",
    "kv_layout",
    "reduce_out",
    "softmax_combine",
    "strategy",
    "use",
    "vocab_embed",
    "vocab_xent",
]

GATHERED = "gathered"
PARTITIONED = "partitioned"
_KINDS = ("train", "prefill", "decode")
# the step kinds partitioned, per family; the rest are gathered
PARTITIONED_STEPS = {"dense": _KINDS, "vlm": _KINDS, "moe": _KINDS, "mla_moe": _KINDS,
                     "mamba2": _KINDS, "zamba2": _KINDS}


def strategy(cfg: ModelConfig, kind: str) -> str:
    """The sharded step's strategy for a family and step kind, by
    :data:`PARTITIONED_STEPS`: the dense decoder's, the MoE families' and
    the Mamba2 and Zamba2 families' train, prefill and decode steps are
    partitioned; Whisper's (``encdec``) are gathered.  A decode over a
    cache the partitioned decode does not split takes
    :func:`decode_strategy` 's rule."""
    return PARTITIONED if kind in PARTITIONED_STEPS.get(cfg.block_pattern, ()) else GATHERED


def attention_mode(cfg: ModelConfig, m: int) -> str:
    """``"heads"`` or ``"replicated"`` on a ``model`` extent ``m`` (module
    docstring)."""
    h, hkv = cfg.n_heads, cfg.n_kv_heads
    return "heads" if h % m == 0 and (hkv % m == 0 or m % hkv == 0) else "replicated"


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


# ---- the model-axis operators ------------------------------------------------


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_in(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` entering a ``model``-split computation: the identity, its
    gradient all-reduced over ``group``."""
    return x if _size(group) == 1 else _CopyIn.apply(x, group)


def reduce_out(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' partial sums of a ``model``-split computation, all-reduced
    over ``group``; the gradient passes through."""
    return x if _size(group) == 1 else _ReduceOut.apply(x, group)


def softmax_combine(out: torch.Tensor, lse: torch.Tensor, group) -> torch.Tensor:
    """Attention over a cache split by the sequence, from each rank's
    partial over its shard: ``out`` (B, H, hd) fp32 normalised over the
    shard's keys, ``lse`` (B, H) fp32 their log-sum-exp (``-inf`` where the
    shard had none).  Weights ``exp(lse - max lse)``, max all-reduced; the
    weighted outputs and the weights summed in one all-reduce; their
    quotient (0 where no rank had a key), fp32.  ``out`` itself with a
    group of one."""
    if _size(group) == 1:
        return out
    top = _all_reduce(lse, group, dist.ReduceOp.MAX)
    w = torch.where(lse == float("-inf"), 0.0, torch.exp(lse - top))
    packed = torch.cat([out * w[..., None], w[..., None]], dim=-1)
    dist.all_reduce(packed, group=group)
    num, den = packed[..., :-1], packed[..., -1:]
    return torch.where(den > 0, num / den.clamp(min=torch.finfo(torch.float32).tiny), 0.0)


def vocab_embed(table: torch.Tensor, tokens: torch.Tensor, lo: int, group) -> torch.Tensor:
    """Embeddings of ``tokens`` from a table split on the vocabulary:
    ``table`` holds rows ``[lo, lo + len(table))``; a rank looks up the
    tokens in its range (zero elsewhere) and the ranks' rows are summed."""
    if _size(group) == 1:
        return torch.nn.functional.embedding(tokens, table)
    n = table.shape[0]
    local = tokens.long() - lo
    inside = (local >= 0) & (local < n)
    x = torch.nn.functional.embedding(local.clamp(0, n - 1), table)
    return reduce_out(torch.where(inside[..., None], x, torch.zeros_like(x)), group)


class _VocabXent(torch.autograd.Function):
    """Per-token ``logsumexp - target logit`` of fp32 logits split on the
    vocabulary (0 where the target is padding)."""

    @staticmethod
    def forward(ctx, logits, targets, lo, group):
        n = logits.shape[-1]
        top = logits.detach().amax(dim=-1)
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
        total = torch.exp(logits - top[..., None]).sum(dim=-1)
        dist.all_reduce(total, group=group)
        local = targets.long() - lo
        mine = (local >= 0) & (local < n)
        picked = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
        picked = torch.where(mine, picked, torch.zeros_like(picked))
        dist.all_reduce(picked, group=group)
        logz = torch.log(total) + top
        valid = targets >= 0
        ctx.save_for_backward(logits, logz, local, mine & valid, valid)
        return torch.where(valid, logz - picked, torch.zeros_like(logz))

    @staticmethod
    def backward(ctx, g):
        logits, logz, local, hit, valid = ctx.saved_tensors
        g = torch.where(valid, g, torch.zeros_like(g))
        grad = torch.exp(logits - logz[..., None]) * g[..., None]
        n = logits.shape[-1]
        grad.scatter_add_(-1, local.clamp(0, n - 1)[..., None],
                          torch.where(hit, -g, torch.zeros_like(g))[..., None])
        return grad, None, None, None


def vocab_xent(logits: torch.Tensor, targets: torch.Tensor, lo: int, group) -> torch.Tensor:
    """Per-token cross-entropy (B, S) of ``logits`` (B, S, V_local) fp32
    holding vocabulary entries ``[lo, lo + V_local)``, targets -1 for
    padding (0 there); with a group of one, the plain math."""
    if _size(group) == 1:
        valid = targets >= 0
        lf = logits.float()
        picked = torch.gather(lf, -1, targets.clamp(min=0).long()[..., None])[..., 0]
        nll = torch.logsumexp(lf, dim=-1) - picked
        return torch.where(valid, nll, torch.zeros_like(nll))
    return _VocabXent.apply(logits, targets, lo, group)


# ---- the per-layer gather -------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Step:
    """One mesh axis of a parameter's gather: ``dim`` the block's dim the
    axis splits (None: the axis replicates it); ``grad`` what the backward
    does over the axis: ``"avg"`` / ``"sum"`` (a reduce-scatter where
    ``dim`` is set, else an all-reduce), ``"slice"`` (take this rank's
    part of a gradient every rank holds whole) or None (nothing)."""

    group: Any
    n: int
    rank: int
    dim: int | None
    grad: str | None


_OPS = {"avg": dist.ReduceOp.AVG, "sum": dist.ReduceOp.SUM}


def _all_gather(x: torch.Tensor, s: Step) -> torch.Tensor:
    x = x.movedim(s.dim, 0).contiguous()
    out = x.new_empty((s.n * x.shape[0],) + x.shape[1:])
    dist.all_gather_into_tensor(out, x, group=s.group)
    return out.movedim(0, s.dim)


def _scatter_back(g: torch.Tensor, s: Step) -> torch.Tensor:
    if s.grad == "slice":
        return g.chunk(s.n, dim=s.dim)[s.rank]
    g = g.movedim(s.dim, 0).contiguous()
    out = g.new_empty((g.shape[0] // s.n,) + g.shape[1:])
    dist.reduce_scatter_tensor(out, g, op=_OPS[s.grad], group=s.group)
    return out.movedim(0, s.dim)


class _Use(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block, steps):
        ctx.steps = steps
        x = block
        for s in steps:
            if s.dim is not None:
                x = _all_gather(x, s)
        return x.view_as(x) if x is block else x

    @staticmethod
    def backward(ctx, g):
        for s in reversed(ctx.steps):
            if s.dim is not None:
                g = _scatter_back(g, s)
            elif s.grad is not None:
                g = _all_reduce(g, s.group, _OPS[s.grad])
        return g, None


def use(block: torch.Tensor, steps: tuple[Step, ...]) -> torch.Tensor:
    """The tensor a rank computes with from its ``block`` (module
    docstring); the block itself where no step communicates."""
    steps = tuple(s for s in steps if s.n > 1 and (s.dim is not None or s.grad is not None))
    return _Use.apply(block, steps) if steps else block


# ---- the partitioned model ---------------------------------------------------------


def _ns(tree: dict) -> types.SimpleNamespace:
    """Nested dicts as attribute namespaces, a projection's absent bias as
    ``b=None`` (what the model functions read)."""
    out = {k: _ns(v) if isinstance(v, dict) else v for k, v in tree.items()}
    if "w" in out:
        out.setdefault("b", None)
    return types.SimpleNamespace(**out)


_KV = (("attn", "wk", "w"), ("attn", "wk", "b"), ("attn", "wv", "w"), ("attn", "wv", "b"))
# MLA's low-rank path, computed whole on every model rank in heads mode
_LOW_RANK = ("q_norm", "k_norm", "wq_a", "q_a_norm", "wkv_a", "kv_a_norm")
_MTP = ("mtp", "block")
_SHARED = ("shared_attn",)  # Zamba2's shared attention + FFN block


def _tail(path: tuple) -> tuple:
    """A parameter's path within its layer (or block)."""
    return path[len(_SHARED):] if path[:1] == _SHARED else path[2:]


@dataclasses.dataclass(frozen=True)
class KVLayout:
    """Where a decode cache's K/V blocks ``(L, B, Hkv, S, hd)`` split:
    ``seq`` the mesh axis that splits the sequence (``"model"``,
    ``"data"`` or None), ``heads`` whether ``model`` splits the KV heads.
    The rows lie on the data axes or whole either way."""

    seq: str | None = "model"
    heads: bool = False

    @property
    def name(self) -> str:
        parts = (["heads"] if self.heads else []) + (
            ["sequence"] if self.seq == "model" else ["sequence on data"] if self.seq else [])
        return " + ".join(parts) or "whole"


def kv_layout(mesh, places: list) -> KVLayout | None:
    """The :class:`KVLayout` of a K/V leaf placed by ``places`` (one per
    mesh axis), or None where the partitioned decode does not take it:
    the head_dim on ``model``, or an axis splitting what no layout of
    ``cache_sharding`` has it split."""
    seq, heads = None, False
    for axis, p in zip(mesh.mesh_dim_names, places):
        if isinstance(p, Replicate) or (p == Shard(1) and axis != "model"):
            continue
        if p == Shard(3) and axis in ("model", "data") and seq is None:
            seq = axis
        elif p == Shard(2) and axis == "model":
            heads = True
        else:
            return None
    return KVLayout(seq, heads)


def decode_strategy(cfg: ModelConfig, mesh, cache_specs: dict) -> str:
    """The decode step's strategy for a cache laid out by ``cache_specs``
    (``cache_sharding`` 's): the family's (:func:`strategy`), but
    ``"gathered"`` where a K/V leaf has no :func:`kv_layout`: its head_dim
    on ``model``, which ``cache_sharding`` gives where neither the
    sequence nor the KV heads divide the ``model`` extent (no published
    cell does; a head's dot products are not split)."""
    if strategy(cfg, "decode") != PARTITIONED:
        return GATHERED
    taken = all(kv_layout(mesh, placements(mesh, spec)) is not None
                for path, spec in _spec_leaves(cache_specs).items() if path[-1] in ("k", "v"))
    return PARTITIONED if taken else GATHERED


class Partitioned:
    """One rank's partitioned model on ``mesh`` (module docstring).

    Its methods take ``blocks``, a dict from a parameter's path (a tuple of
    names, as ``param_tree`` nests them) to this rank's local block (a
    plain tensor, the ``DTensor`` 's ``to_local()``): :meth:`forward` gives
    the logits split on the vocabulary, the aux loss and the MTP head's
    split logits, :meth:`xent` their per-token cross-entropy,
    :meth:`prefill` the last position's split logits and a cache of the
    rank's KV heads (MLA: the whole latent; Mamba2: the state of its SSD
    heads), :meth:`decode` one step over the rank's ``cache_sharding``
    blocks.  ``split`` says whether the batch's rows are split over the
    data axes (else every rank holds them all): the MoE's global capacity
    counts the shards' tokens only then."""

    def __init__(self, cfg: ModelConfig, mesh):
        if strategy(cfg, "train") != PARTITIONED:
            raise ValueError(f"{cfg.name}: the {cfg.block_pattern!r} family is not partitioned")
        self.cfg = cfg
        sizes = mesh_sizes(mesh)
        self.m, self.r = sizes["model"], mesh.get_local_rank("model")
        self.tp = mesh.get_group("model") if self.m > 1 else None
        self.mla = cfg.block_pattern == "mla_moe"
        self.zamba = cfg.block_pattern == "zamba2"
        # the Mamba2 layers' mode (None: no Mamba2 layers), and the attention
        # + FFN block whose leaves the rules read (None: no such block)
        self.ssm = ssm_mode(cfg, self.m) if cfg.block_pattern in ("mamba2", "zamba2") else None
        self.decoder = (None if cfg.block_pattern == "mamba2"
                        else _SHARED if self.zamba else ("layers", "0"))
        self.attention = attention_mode(cfg, self.m) if self.decoder else None
        self.local_cfg = cfg
        self.kv = None  # the KV heads' columns this rank takes from the whole wk / wv
        if self.attention == "heads":
            h_l = cfg.n_heads // self.m
            hkv_l = max(1, cfg.n_kv_heads // self.m)
            self.local_cfg = dataclasses.replace(cfg, n_heads=h_l, n_kv_heads=hkv_l,
                                                 head_dim=cfg.head_dim_)
            if cfg.n_kv_heads % self.m and not self.mla:
                head = self.r // (self.m // cfg.n_kv_heads)
                self.kv = slice(head * cfg.head_dim_, (head + 1) * cfg.head_dim_)
        self.dp_index = data_shard(mesh)[1]
        self.data_axes = tuple((mesh.get_group(a), sizes[a]) for a in fsdp_axes(mesh)
                               if sizes[a] > 1)
        # the data axis a decode cache's sequence may lie on: its group and index
        self.seq_data = ((mesh.get_group("data"), mesh.get_local_rank("data"))
                         if sizes["data"] > 1 else (None, 0))
        skeleton = FAMILIES[cfg.block_pattern](cfg, device="meta")
        specs = _spec_leaves(param_sharding(mesh, skeleton))
        on_model = mesh.mesh_dim_names.index("model")

        def on_model_split(*path: str) -> bool:
            return isinstance(placements(mesh, specs[path])[on_model], Shard)

        self.moe = bool(cfg.moe.n_experts)
        self.experts_split = self.ffn_split = self.wo_split = False
        self.e_loc, self.qkv_split, self.wkv_b = cfg.moe.n_experts, (), None
        if self.decoder:
            ffn, attn = self.decoder + ("ffn",), self.decoder + ("attn",)
            # the routed experts split on model (a rank holds E/m of them), and
            # the dense FFN's or the shared expert's halves
            self.experts_split = self.moe and on_model_split(*ffn, "experts", "wi_gate")
            self.e_loc = cfg.moe.n_experts // self.m if self.experts_split else cfg.moe.n_experts
            ffn_wo = ffn + (("shared",) if self.moe else ()) + ("wo", "w")  # absent: no shared
            self.ffn_split = ffn_wo in specs and on_model_split(*ffn_wo)
            q_names = ("wq_b",) if self.mla else ("wq", "wk", "wv")
            self.qkv_split = tuple(on_model_split(*attn, n, "w") for n in q_names)
            self.wo_split = on_model_split(*attn, "wo", "w")
            self.wkv_b = (Step(self.tp, self.m, self.r, 1, None)
                          if self.mla and on_model_split(*attn, "wkv_b", "w") else None)
        if self.ssm:
            mixer = ("layers", "0", "mamba")
            self.in_split = on_model_split(*mixer, "in_proj", "w")
            self.out_split = on_model_split(*mixer, "out_proj")
        self.steps = {path: self._steps(mesh, path, placements(mesh, spec))
                      for path, spec in specs.items()}
        # decode's: the data axes only (model-split projections used as blocks)
        self.decode_steps = {path: self._steps(mesh, path, placements(mesh, spec), model=False)
                             for path, spec in specs.items()}
        split_vocab = on_model_split("embed", "table")
        self.vocab_group = self.tp if split_vocab else None
        self.vocab_lo = self.r * cfg.vocab // self.m if split_vocab else 0

    def _model_grad(self, path: tuple, sharded: bool) -> str | None:
        """What the backward does over ``model`` for a parameter (module
        docstring): heads-mode ``wk/wv`` taken whole and sliced, the
        per-head norms, MLA's low-rank path and, where the experts split,
        the router have partial gradients (summed); replicated-mode
        attention weights are taken whole, their gradients sliced; a
        Mamba2 mixer's as :meth:`_mixer_grad` says."""
        tail = _tail(path)
        if tail[:1] == ("mamba",):
            return self._mixer_grad(tail[1], sharded)
        if tail[:2] == ("ffn", "router"):
            return "sum" if self.experts_split else None
        if tail[:1] != ("attn",):
            return None
        if self.attention == "replicated":
            return "slice" if sharded else None
        if tail[1] in _LOW_RANK:
            return "sum"
        if tail in _KV and self.kv is not None:
            return "sum"
        return None

    def _mixer_grad(self, name: str, sharded: bool) -> str | None:
        """A Mamba2 weight's (:mod:`.ssm`): ``out_proj`` 's block is the
        rank's own; in ``"heads"`` mode, or where ``out_proj`` 's row block
        takes the rank's slice of ``y``, every other gradient is partial
        (summed); else whole on every rank (a split ``in_proj`` sliced)."""
        if name == "out_proj":
            return None
        if self.ssm == "heads" or self.out_split:
            return "sum"
        return "slice" if sharded else None

    def _steps(self, mesh, path: tuple, places: list, model: bool = True) -> tuple[Step, ...]:
        """The forward's steps: the data axes inner first (a dim split over
        (pod, data) gathers data, then pod), then ``model`` (unless not
        ``model``); the backward runs them in reverse, so a sliced or
        summed ``model`` gradient shrinks before the data axes'
        reduce-scatters."""
        dp = fsdp_axes(mesh)
        names = mesh.mesh_dim_names
        order = [names.index(a) for a in reversed(dp)]
        if model:
            order.append(names.index("model"))
        out = []
        for i in order:
            p = places[i]
            dim = p.dim if isinstance(p, Shard) else None
            if names[i] == "model":
                grad = self._model_grad(path, dim is not None)
                if dim is not None and grad is None:
                    continue  # used as this rank's block
            else:
                grad = "avg"
            out.append(Step(mesh.get_group(i) if mesh.shape[i] > 1 else None,
                            mesh.shape[i], mesh.get_local_rank(i), dim, grad))
        return tuple(out)

    # -- parameters --

    def use(self, blocks: dict, path: tuple, decode: bool = False) -> torch.Tensor:
        return use(blocks[path], (self.decode_steps if decode else self.steps)[path])

    def _layer_params(self, blocks: dict, prefix: tuple,
                      decode: bool = False) -> types.SimpleNamespace:
        """The layer or block at ``prefix`` (``("layers", i)``, the MTP
        block's or Zamba2's shared block's)."""
        tree: dict = {}
        for path in self.steps:
            if path[:len(prefix)] != prefix:
                continue
            t = self.use(blocks, path, decode)
            tail = path[len(prefix):]
            if self.kv is not None and tail in _KV and not decode:
                t = t[..., self.kv]
            node = tree
            for k in tail[:-1]:
                node = node.setdefault(k, {})
            node[tail[-1]] = t
        return _ns(tree)

    # -- the model --

    def _attend(self, a, h: torch.Tensor, rope):
        """Attention of one layer: ``(out, k, v)``, k and v the rank's KV
        heads as ``(B, Hkv_local, S, hd)`` (MLA: ``c_kv`` and ``k_rope``
        whole)."""
        fn = mla_prefill if self.mla else gqa_prefill
        if self.attention == "replicated":
            return fn(a, self.cfg, h, rope)
        out, k, v = fn(a, self.local_cfg, copy_in(h, self.tp), rope)
        return reduce_out(out, self.tp), k, v

    def _ffn(self, f, h: torch.Tensor, *, split: bool, no_drop: bool = False):
        """The FFN of one layer: ``(y, aux)``.  The parts ``model`` splits
        take ``copy_in`` 's input and meet in one :func:`reduce_out`; a part
        it leaves whole is added after."""
        if not self.moe:
            y = swiglu(f, copy_in(h, self.tp) if self.ffn_split else h)
            return (reduce_out(y, self.tp) if self.ffn_split else y), _zero_aux(h)
        xin = copy_in(h, self.tp) if self.experts_split or self.ffn_split else h
        y, aux = moe_partitioned(
            f, self.cfg, xin if self.experts_split else h, first=self.r * self.e_loc
            if self.experts_split else 0, e_loc=self.e_loc, m=self.m if self.experts_split else 1,
            data=self.data_axes if split else (), index=self.dp_index, no_drop=no_drop)
        parts: dict = {True: [], False: []}
        parts[self.experts_split].append(y)
        if hasattr(f, "shared"):
            parts[self.ffn_split].append(swiglu(f.shared, xin if self.ffn_split else h))
        out = [reduce_out(functools.reduce(operator.add, parts[True]), self.tp)] \
            if parts[True] else []
        return functools.reduce(operator.add, out + parts[False]), aux

    def _mix(self, mp, h: torch.Tensor):
        """A Mamba2 layer's mixer on this rank (:mod:`.ssm`): ``(y, (conv,
        ssm))``, the state of the rank's heads (``"replicated"``: whole);
        with a ``model`` group of one, ``mamba2_apply`` itself."""
        cfg = self.cfg
        if self.tp is None or not (self.ssm == "heads" or self.out_split):
            return mamba2_apply(mp, cfg, h)
        if self.ssm == "heads":
            norm = functools.partial(gated_norm, group=self.tp, width=mp.norm_g.shape[0])
            mp = heads_view(mp, cfg, self.r, self.m)
            y, state = mamba2_mix(mp, cfg, copy_in(h, self.tp), norm=norm)
        else:  # the rank's slice of the whole y meets out_proj's row block
            y, state = mamba2_mix(mp, cfg, copy_in(h, self.tp))
            n = mp.out_proj.shape[0]
            y = y[..., self.r * n:(self.r + 1) * n]
        return reduce_out(y @ mp.out_proj, self.tp), state

    def _layer(self, blocks: dict, prefix: tuple, x: torch.Tensor, rope, split: bool):
        p = self._layer_params(blocks, prefix)
        eps = self.cfg.norm_eps
        if hasattr(p, "mamba"):
            return x + self._mix(p.mamba, rmsnorm(p.norm1, x, eps))[0], _zero_aux(x)
        x = x + self._attend(p.attn, rmsnorm(p.norm1, x, eps), rope)[0]
        y, aux = self._ffn(p.ffn, rmsnorm(p.norm2, x, eps), split=split)
        return x + y, aux

    def _run(self, blocks: dict, prefix: tuple, x: torch.Tensor, rope, remat: bool,
             split: bool):
        if remat and torch.is_grad_enabled():
            return checkpoint(self._layer, blocks, prefix, x, rope, split, use_reentrant=False)
        return self._layer(blocks, prefix, x, rope, split)

    def _uses(self, i: int) -> list[tuple]:
        """The blocks run at layer ``i``: Zamba2's shared block before every
        ``hybrid_period`` th, then the layer."""
        shared = self.zamba and i % self.cfg.hybrid_period == 0
        return ([_SHARED] if shared else []) + [("layers", str(i))]

    def _embed_inputs(self, table: torch.Tensor, batch: dict):
        """As ``models.model._embed_inputs``, the lookup split on the
        vocabulary."""
        x = vocab_embed(table, batch["tokens"], self.vocab_lo, self.vocab_group)
        if self.cfg.block_pattern == "vlm" and "patches" in batch:
            x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
        b, s, _ = x.shape
        return x, torch.arange(s, device=x.device)[None, :].expand(b, s)

    def _rope(self, positions: torch.Tensor):
        return None if self.decoder is None else rope_for(self.cfg, positions)

    def _unembed(self, table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return (copy_in(x, self.vocab_group) @ table.T).float()

    def forward(self, blocks: dict, batch: dict, *, remat: bool = True, split: bool = True):
        """``forward_train`` partitioned: ``(logits, aux, mtp_logits | None)``,
        the logits (B_local, S, V_local) fp32 this rank's vocabulary
        entries ``[vocab_lo, vocab_lo + V_local)`` (the MTP head's likewise,
        over S - 1 positions), aux the MoE loss summed over layers;
        ``remat`` recomputes each layer (and each use of Zamba2's shared
        block), its gathers included, in the backward."""
        cfg = self.cfg
        table = self.use(blocks, ("embed", "table"))
        x, positions = self._embed_inputs(table, batch)
        rope = self._rope(positions)
        aux = _zero_aux(x)
        for i in range(cfg.n_layers):
            for prefix in self._uses(i):
                x, a = self._run(blocks, prefix, x, rope, remat, split)
                aux = aux + a
        x = rmsnorm(_ns({"g": self.use(blocks, ("final_norm", "g"))}), x, cfg.norm_eps)
        if cfg.block_pattern == "vlm" and "patches" in batch:
            x = x[:, batch["patches"].shape[1]:]
        logits = self._unembed(table, x)
        if not (cfg.mtp_depth and ("mtp", "proj", "w") in blocks):
            return logits, aux, None
        # MTP: token t+2 from (hidden_t, embed_{t+1}); its aux is not counted
        emb = vocab_embed(table, batch["tokens"], self.vocab_lo, self.vocab_group)
        h = torch.cat([x[:, :-1], emb[:, 1:]], dim=-1) @ self.use(blocks, ("mtp", "proj", "w"))
        h, _ = self._run(blocks, _MTP, h, rope_for(cfg, positions[:, :-1]), remat, split)
        h = rmsnorm(_ns({"g": self.use(blocks, ("mtp", "norm", "g"))}), h, cfg.norm_eps)
        return logits, aux, self._unembed(table, h)

    def xent(self, logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        """Per-token cross-entropy of :meth:`forward`'s logits (0 at padding)."""
        return vocab_xent(logits, targets, self.vocab_lo, self.vocab_group)

    def _prefill_block(self, blocks: dict, prefix: tuple, x: torch.Tensor, rope, kv: dict,
                       i: int, split: bool) -> torch.Tensor:
        """One attention + FFN block over the prompt, its cache rows (the
        rank's KV heads, or MLA's latent) written into use ``i`` of ``kv``."""
        eps, s = self.cfg.norm_eps, x.shape[1]
        p = self._layer_params(blocks, prefix)
        h, k, v = self._attend(p.attn, rmsnorm(p.norm1, x, eps), rope)
        if self.mla:
            kv["c_kv"][i, :, :s] = k
            kv["k_rope"][i, :, :s] = v
        else:
            kv["k"][i, :, :, :s] = k
            kv["v"][i, :, :, :s] = v
        x = x + h
        return x + self._ffn(p.ffn, rmsnorm(p.norm2, x, eps), split=split)[0]

    @torch.no_grad()
    def prefill(self, blocks: dict, batch: dict, *, max_len: int | None = None,
                split: bool = True):
        """``models.prefill`` partitioned: the last position's logits (B, 1,
        V_local) fp32, split on the vocabulary as :meth:`forward` 's, and
        the cache of this rank's KV heads, ``{"layers": {"k", "v"} (L, B,
        Hkv_local, S_max, hd), "pos"}`` (MLA: the whole latent, ``{"c_kv",
        "k_rope"} (L, B, S_max, r)``; Mamba2: ``{"conv" (L, B, W-1,
        C_local), "ssm" (L, B, H_local, P, N)}``, the rank's heads' state
        (``"replicated"``: whole); Zamba2: ``{"attn": KV heads over the
        shared block's uses, "mamba": the state}``); each layer's weights
        gathered in turn and freed."""
        cfg = self.cfg
        table = self.use(blocks, ("embed", "table"))
        x, positions = self._embed_inputs(table, batch)
        b, s, _ = x.shape
        rope = self._rope(positions)
        length = max(s, max_len or 0)
        uses = cfg.n_layers // cfg.hybrid_period if self.zamba else cfg.n_layers
        kv = None
        if self.mla:
            ml = cfg.mla
            kv = {"c_kv": x.new_zeros((uses, b, length, ml.kv_lora_rank)),
                  "k_rope": x.new_zeros((uses, b, length, ml.qk_rope_head_dim))}
        elif self.decoder:
            hkv = (cfg.n_kv_heads if self.attention == "replicated"
                   else self.local_cfg.n_kv_heads)
            shape = (uses, b, hkv, length, cfg.head_dim_)
            kv = {"k": x.new_zeros(shape), "v": x.new_zeros(shape)}
        state: dict = {}
        for i in range(cfg.n_layers):
            for prefix in self._uses(i):
                if prefix == _SHARED or self.ssm is None:
                    use = i // cfg.hybrid_period if prefix == _SHARED else i
                    x = self._prefill_block(blocks, prefix, x, rope, kv, use, split)
                    continue
                p = self._layer_params(blocks, prefix)
                h, layer_state = self._mix(p.mamba, rmsnorm(p.norm1, x, cfg.norm_eps))
                for k, t in zip(("conv", "ssm"), layer_state):
                    if k not in state:
                        state[k] = t.new_zeros((cfg.n_layers,) + tuple(t.shape))
                    state[k][i] = t
                x = x + h
                del p, h, layer_state
        final = _ns({"g": self.use(blocks, ("final_norm", "g"))})
        x = rmsnorm(final, x[:, -1:].contiguous(), cfg.norm_eps)
        pos = torch.full((b,), s, dtype=torch.int32, device=x.device)
        layers = {"attn": kv, "mamba": state} if self.zamba else state if self.ssm else kv
        return self._unembed(table, x), {"layers": layers, "pos": pos}

    # -- decode --

    def _gather_qkv(self, *rows: torch.Tensor):
        """The projections' one-token rows made whole: the column blocks
        ``model`` splits all-gathered in one call, rank-major."""
        split = [t for t, c in zip(rows, self.qkv_split) if c]
        if not split:
            return rows
        local = torch.cat(split, dim=-1)
        buf = local.new_empty((self.m * local.shape[0],) + tuple(local.shape[1:]))
        dist.all_gather_into_tensor(buf, local, group=self.tp)
        buf = buf.view(self.m, *local.shape)
        parts = iter(buf.split([t.shape[-1] for t in split], dim=-1))
        out = []
        for t, c in zip(rows, self.qkv_split):
            if c:
                part = next(parts).movedim(0, -2)  # (..., m, width)
                t = part.reshape(*part.shape[:-2], self.m * part.shape[-1])
            out.append(t)
        return tuple(out)

    @staticmethod
    def _attend_shard(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos: torch.Tensor,
                      *, group) -> torch.Tensor:
        """K5's partial mode over this rank's shard, the ranks' partials
        combined over ``group`` in fp32 and cast once."""
        out, lse = ops.decode_attention_partial(q, k, v, pos)
        return softmax_combine(out, lse, group).to(q.dtype)

    def _wo(self, wo, heads: torch.Tensor) -> torch.Tensor:
        """``wo`` of the heads' outputs (B, H, hd): row-parallel on the
        rank's column slice, then :func:`reduce_out`, where ``model`` splits
        it; else whole."""
        b = heads.shape[0]
        x = heads.reshape(b, 1, -1)
        if not (self.wo_split and self.tp is not None):
            return dense(wo, x)
        n = wo.w.shape[0]
        return reduce_out(dense(wo, x[..., self.r * n:(self.r + 1) * n]), self.tp)

    def _gqa_decode(self, a, h: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                    local: torch.Tensor, rope, slots, layout: KVLayout) -> torch.Tensor:
        """GQA's one-token step over this rank's K/V blocks laid out as
        ``layout`` (module docstring): K5's partial mode and the softmax
        combine where an axis of more than one rank splits the sequence,
        else its whole-cache mode; by heads, the rank's column blocks and
        ``wo`` 's row block, else the rows made whole and ``wo`` 's slice."""
        group = {"model": self.tp, "data": self.seq_data[0], None: None}[layout.seq]
        attend = None if group is None else functools.partial(self._attend_shard, group=group)
        if layout.heads and self.tp is not None:
            heads = gqa_decode_heads(a, self.local_cfg, h, cache_k, cache_v, local, rope, slots,
                                     attend=attend)
            return reduce_out(dense(a.wo, heads.reshape(h.shape[0], 1, -1)), self.tp)
        heads = gqa_decode_heads(a, self.cfg, h, cache_k, cache_v, local, rope, slots,
                                 gather=None if self.tp is None else self._gather_qkv,
                                 attend=attend)
        return self._wo(a.wo, heads)

    def _mla_decode(self, a, h: torch.Tensor, cache_c: torch.Tensor, cache_r: torch.Tensor,
                    local: torch.Tensor, rope, slots) -> torch.Tensor:
        """MLA's one-token step over this rank's shard of the latent cache
        (B, S/m, r) at shard-local positions ``local`` (module docstring);
        ``mla_decode`` over the whole cache with a ``model`` group of one."""
        cfg = self.cfg
        if self.tp is None:
            return mla_decode(a, cfg, h, cache_c, cache_r, local, rope, slots)
        ml, nh, b = cfg.mla, cfg.n_heads, h.shape[0]
        qk = ml.qk_nope_head_dim + ml.qk_rope_head_dim
        q_nope, q_rope, c_new, r_new = _mla_qkv(a, cfg, h, rope, gather=self._gather_qkv)
        write_latent_rows(cache_c, c_new[:, 0], slots)
        write_latent_rows(cache_r, r_new[:, 0], slots)
        wkv_b = a.wkv_b.w if self.wkv_b is None else _all_gather(a.wkv_b.w, self.wkv_b)
        t = cache_c.shape[1]
        k_nope, v = (cache_c @ wkv_b).reshape(b, t, nh, ml.qk_nope_head_dim + ml.v_head_dim) \
            .split([ml.qk_nope_head_dim, ml.v_head_dim], dim=-1)
        logits = (torch.einsum("bsnh,btnh->bnst", q_nope, k_nope)
                  + torch.einsum("bsnh,bth->bnst", q_rope, cache_r)).float()[:, :, 0]
        logits.mul_(qk ** -0.5)
        valid = (torch.arange(t, device=h.device)[None, :] <= local[:, None])[:, None]
        logits.masked_fill_(~valid, float("-inf"))
        lse = torch.logsumexp(logits, dim=-1)  # (B, H); -inf where the shard has no key
        probs = torch.where(valid, torch.exp(logits - lse[..., None]), 0.0)
        out = torch.einsum("bnt,btnh->bnh", probs, v.float())
        return self._wo(a.wo, softmax_combine(out, lse, self.tp).to(h.dtype))

    def _decode_block(self, blocks: dict, prefix: tuple, x: torch.Tensor, kv: dict, i: int,
                      local: torch.Tensor, rope, slots, layout: KVLayout) -> torch.Tensor:
        """One attention + FFN block's step over use ``i`` of ``kv``."""
        eps = self.cfg.norm_eps
        p = self._layer_params(blocks, prefix, decode=True)
        h = rmsnorm(p.norm1, x, eps)
        if self.mla:
            x = x + self._mla_decode(p.attn, h, kv["c_kv"][i], kv["k_rope"][i], local, rope,
                                     slots)
        else:
            x = x + self._gqa_decode(p.attn, h, kv["k"][i], kv["v"][i], local, rope, slots,
                                     layout)
        return x + self._ffn(p.ffn, rmsnorm(p.norm2, x, eps), split=False, no_drop=True)[0]

    def _decode_mixer(self, blocks: dict, prefix: tuple, x: torch.Tensor, state: dict,
                      i: int) -> torch.Tensor:
        """One Mamba2 layer's step over layer ``i`` of ``state`` (whole on
        ``model``; :mod:`.ssm`), the new state written in place."""
        cfg = self.cfg
        p = self._layer_params(blocks, prefix, decode=True)
        h = rmsnorm(p.norm1, x, cfg.norm_eps)
        mp, now = p.mamba, (state["conv"][i], state["ssm"][i])
        if self.tp is None:
            y, (conv, ssm) = mamba2_decode(mp, cfg, h, now)
        else:
            gather = (functools.partial(gather_columns, group=self.tp, m=self.m)
                      if self.in_split else None)
            if self.ssm == "heads":  # y of the rank's heads: out_proj's row block
                h_l = mp.A_log.shape[0] // self.m
                norm = functools.partial(gated_norm, group=self.tp, width=mp.norm_g.shape[0])
                y, (conv, ssm) = mamba2_decode_mix(mp, cfg, h, now, gather=gather, norm=norm,
                                                   heads=slice(self.r * h_l, (self.r + 1) * h_l))
            else:
                y, (conv, ssm) = mamba2_decode_mix(mp, cfg, h, now, gather=gather)
                if self.out_split:
                    n = mp.out_proj.shape[0]
                    y = y[..., self.r * n:(self.r + 1) * n]
            y = reduce_out(y @ mp.out_proj, self.tp) if self.out_split else y @ mp.out_proj
        state["conv"][i].copy_(conv)
        state["ssm"][i].copy_(ssm)
        return x + y

    @torch.no_grad()
    def decode(self, blocks: dict, tokens: torch.Tensor, cache: dict,
               layout: KVLayout = KVLayout()):
        """``models.decode_step`` partitioned (module docstring).  ``tokens``
        (B_local, 1), this rank's rows; ``cache`` this rank's
        ``cache_sharding`` blocks, the K/V (MLA: latent) blocks laid out as
        ``layout`` says (by default the sequence on ``model``: ``{"k", "v"}
        (L, B_local, Hkv, S_max / m, hd)``, MLA's ``{"c_kv", "k_rope"} (L,
        B_local, S_max / m, r)``), a Mamba2 state ``{"conv", "ssm"}`` the
        rows' whole, ``pos`` (B,) replicated; Zamba2's ``{"attn", "mamba"}``.
        Returns the logits (B_local, 1, V_local) fp32, split on the
        vocabulary as :meth:`forward` 's, and the cache: this step's rows
        written in place into the shard that holds their position, the
        state in place, ``pos + 1``."""
        cfg = self.cfg
        layers, pos = cache["layers"], cache["pos"]
        kv = layers["attn"] if self.zamba else None if self.ssm else layers
        state = layers["mamba"] if self.zamba else layers if self.ssm else None
        b = tokens.shape[0]
        mine = pos if pos.shape[0] == b else pos.narrow(0, self.dp_index * b, b)
        table = self.use(blocks, ("embed", "table"), decode=True)
        x = vocab_embed(table, tokens, self.vocab_lo, self.vocab_group)
        local = rope = slots = None
        if kv is not None:
            s_local = kv["c_kv"].shape[2] if self.mla else kv["k"].shape[3]
            shard = {"model": self.r, "data": self.seq_data[1], None: 0}[layout.seq]
            local = mine - shard * s_local  # shard-local; negative past this shard's start
            rope, slots = rope_for(cfg, mine[:, None]), cache_slots(local, s_local)
        for i in range(cfg.n_layers):
            for prefix in self._uses(i):
                if prefix == _SHARED or self.ssm is None:
                    use = i // cfg.hybrid_period if prefix == _SHARED else i
                    x = self._decode_block(blocks, prefix, x, kv, use, local, rope, slots,
                                           layout)
                else:
                    x = self._decode_mixer(blocks, prefix, x, state, i)
        final = _ns({"g": self.use(blocks, ("final_norm", "g"), decode=True)})
        x = rmsnorm(final, x[:, -1:].contiguous(), cfg.norm_eps)
        return self._unembed(table, x), {"layers": layers, "pos": pos + 1}
