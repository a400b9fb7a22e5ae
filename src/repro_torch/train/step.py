"""Train step: loss, gradients, AdamW; on one device or sharded on a mesh.

The port's counterpart of ``repro/train/step.py``.
``make_train_step(cfg, opt_cfg, microbatches=N)`` builds a step that
accumulates gradients over N microbatches (activation memory follows
the microbatch; one optimizer update per global batch), as the
reference's ``lax.scan`` does.  The gradients come from autograd through
:func:`repro_torch.models.forward_train`, whose kernels (K4, K6, K7) are
entered through their ``torch.autograd.Function`` s.  The state is
``{"params": model, "opt": tree}``: the model (an ``nn.Module``) is
updated in place, the optimizer tree
(:func:`repro_torch.train.optim.adamw_init`) replaced by the new one.

With ``mesh=`` (a ``DeviceMesh`` over an initialised process group) the
step is the counterpart of the reference's ``jax.jit(make_train_step(...),
in_shardings=(state_sh, batch_sh))``, written SPMD: every rank calls it
with the same global batch, and the state is the tree of
:func:`shard_train_state`, the parameters and both moments ``DTensor``
blocks placed by ``param_sharding``, ``step`` replicated.  Each step:

- gathers the full parameters (once per step: the peak holds the full
  parameters, their fp32 gradients and this rank's blocks of the state)
  into a model on plain tensors, so the kernels never see a ``DTensor``;
- takes this rank's rows of each global microbatch on the data-parallel
  axes where they divide it (``batch_sharding``), else the whole of it;
- normalises the cross-entropy (and the MTP head's) by the valid
  targets of the *global* microbatch, so the data shards' losses add up
  to the single-device loss;
- reduces each gradient to its parameter's placements (the data axes
  averaged; the ``model`` axis replicated, but for the expert tensors of
  the expert-parallel MoE, whose ranks each hold their slice's gradient:
  summed);
- clips by the global norm summed over the shards once (a block held by
  several ranks counts once) and applies ``adamw_update`` to the blocks.

An MoE under the default ``"gspmd"`` dispatch routes the whole batch with
its global capacity (the data shards' tokens gathered: :func:`repro_torch.
models.moe_sharded.moe_apply_global`); under ``"shard_map"`` it takes the
expert-parallel dispatch, whose capacity is per data shard, as the
reference's.  The reference's ``logits_sharding`` (a layout pin that keeps
the vocab axis on ``model`` through the cross-entropy) has no
counterpart: a rank computes its logits whole, as plain tensors, and
there is no layout propagation to pin.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
from typing import Callable, Iterator

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate

from ..models import forward_train, init_params
from ..models.config import ModelConfig
from ..models.model import FAMILIES, LM
from ..models.moe_sharded import expert_parallel
from ..parallel.constrain import set_mesh, split_batch
from ..parallel.sharding import data_shard, fsdp_axes, param_sharding, shard_state
from .optim import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    nest,
    param_tree,
    tree_leaves,
    tree_map,
)

__all__ = [
    "MTP_WEIGHT",
    "TrainState",
    "gathered",
    "loss_fn",
    "make_train_step",
    "shard_train_state",
    "softmax_xent",
    "state_sharding",
    "train_state_init",
]

MTP_WEIGHT = 0.3


@dataclasses.dataclass
class TrainState:
    params: LM
    opt: dict

    def as_dict(self) -> dict:
        return {"params": self.params, "opt": self.opt}

    def tree(self) -> dict:
        """The state as one tree of tensors (what a checkpoint holds):
        ``{"params": param_tree(params), "opt": opt}``."""
        return {"params": param_tree(self.params), "opt": self.opt}


def softmax_xent(logits: torch.Tensor, targets: torch.Tensor,
                 count: torch.Tensor | int | None = None) -> torch.Tensor:
    """Mean cross-entropy over non-negative targets (-1 = padding), in
    fp32: ``logsumexp - picked logit`` summed over the valid targets and
    divided by their number, or by ``count`` where given (the valid
    targets of the whole batch, when ``targets`` are one shard of it)."""
    valid = targets >= 0
    safe = targets.clamp(min=0).long()
    lf = logits.float()
    logz = torch.logsumexp(lf, dim=-1)
    picked = torch.gather(lf, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, logz - picked, torch.zeros_like(logz))
    return nll.sum() / (valid.sum().clamp(min=1) if count is None else count)


def train_state_init(
    generator: torch.Generator, cfg: ModelConfig, opt_cfg: AdamWConfig
) -> TrainState:
    """Random parameters (:func:`repro_torch.models.init_params`) and zero
    optimizer moments."""
    params = init_params(generator, cfg)
    return TrainState(params=params, opt=adamw_init(opt_cfg, params))


def loss_fn(
    params: LM, cfg: ModelConfig, batch: dict, *, remat: bool = True,
    counts: tuple | None = None, scale: float = 1.0,
) -> tuple[torch.Tensor, dict]:
    """``(loss, metrics)``: cross-entropy on ``batch["targets"]`` plus the
    MoE aux loss, plus ``MTP_WEIGHT`` times the MTP head's cross-entropy
    on the targets one position on (where the model has the head).
    ``counts`` (the sharded step's) normalises the two cross-entropies by
    the global microbatch's valid targets, and ``scale`` multiplies them
    in the loss (not in the metrics)."""
    ce_count, mtp_count = counts or (None, None)
    logits, aux, mtp_logits = forward_train(params, cfg, batch, remat=remat)
    ce = softmax_xent(logits, batch["targets"], ce_count)
    loss = scale * ce + aux
    metrics = {"ce": ce, "aux": aux}
    if mtp_logits is not None:
        # MTP predicts token t+2: logits index i <-> target index i+1
        mtp_ce = softmax_xent(mtp_logits, batch["targets"][:, 1:], mtp_count)
        loss = loss + MTP_WEIGHT * scale * mtp_ce
        metrics["mtp_ce"] = mtp_ce
    metrics["loss"] = loss
    return loss, metrics


def _grads(params: LM, cfg: ModelConfig, batch: dict, remat: bool,
           **loss_kw) -> tuple[dict, dict]:
    """Gradients of the loss (a tree keyed like ``param_tree``) and the
    metrics, detached."""
    names, leaves = zip(*params.named_parameters())
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = loss_fn(params, cfg, batch, remat=remat, **loss_kw)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return nest(dict(zip(names, grads))), {k: v.detach() for k, v in metrics.items()}


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: AdamWConfig,
    *,
    microbatches: int = 1,
    remat: bool = True,
    mesh=None,
) -> Callable:
    """Returns ``train_step(state_dict, batch) -> (state_dict, metrics)``.

    ``state_dict`` is ``{"params": model, "opt": tree}``
    (:meth:`TrainState.as_dict`); the model's parameters are overwritten
    with the updated ones and the returned dict holds the new optimizer
    tree.  With ``microbatches > 1`` the batch's leading dim is split,
    and the gradients of the parts are summed in fp32 and divided by
    their number.  Metrics are 0-d tensors (the microbatches' mean).
    With ``mesh`` the step is the sharded one (module docstring): its
    state is :func:`shard_train_state`'s, returned anew."""
    if mesh is not None:
        return _sharded_train_step(cfg, opt_cfg, microbatches, remat, mesh)

    def accumulated(params: LM, batch: dict) -> tuple[dict, dict]:
        parts = {k: v.chunk(microbatches, dim=0) for k, v in batch.items()}
        total, metrics = None, []
        for i in range(microbatches):
            grads, m = _grads(params, cfg, {k: v[i] for k, v in parts.items()}, remat)
            grads = tree_map(lambda g: g.float(), grads)
            total = grads if total is None else tree_map(torch.add, total, grads)
            metrics.append(m)
        total = tree_map(lambda g: g / microbatches, total)
        return total, {k: torch.stack([m[k] for m in metrics]).mean() for k in metrics[0]}

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        params, opt = state["params"], state["opt"]
        if microbatches > 1:
            grads, metrics = accumulated(params, batch)
        else:
            grads, metrics = _grads(params, cfg, batch, remat)
        new_params, new_opt, opt_metrics = adamw_update(opt_cfg, grads, opt, params)
        with torch.no_grad():
            tree_map(lambda p, new: p.copy_(new), param_tree(params), new_params)
        metrics.update(opt_metrics)
        return {"params": params, "opt": new_opt}, metrics

    return train_step


# ---- the sharded step ------------------------------------------------------


def state_sharding(mesh, tree: dict) -> dict:
    """The specs of a ``TrainState.tree()``: the parameters and both
    moments by ``param_sharding``, ``step`` replicated."""
    opt = tree["opt"]
    return {"params": param_sharding(mesh, tree["params"]),
            "opt": {"m": param_sharding(mesh, opt["m"]), "v": param_sharding(mesh, opt["v"]),
                    "step": ()}}


def shard_train_state(mesh, state: TrainState) -> dict:
    """The sharded step's state from a full one that every rank holds
    identically: ``{"params": ..., "opt": {"m", "v", "step"}}`` of
    ``DTensor`` blocks (:func:`repro_torch.parallel.shard_state`)."""
    tree = state.tree()
    return shard_state(mesh, tree, state_sharding(mesh, tree))


def _sharded_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, microbatches: int,
                        remat: bool, mesh) -> Callable:
    if not dist.is_initialized():
        raise RuntimeError("the sharded train step needs an initialised process group "
                           "(torch.distributed.init_process_group); it never runs unsharded")
    dp = fsdp_axes(mesh)
    n_dp, dp_index = data_shard(mesh)
    skeleton = FAMILIES[cfg.block_pattern](cfg, device="meta")
    experts_summed = expert_parallel(cfg, mesh)
    names = mesh.mesh_dim_names

    def grad_placements(path: tuple, split: bool) -> list:
        """Where a rank's full gradient stands before its reduction."""
        out = []
        for a in names:
            if a in dp:
                out.append(Partial("avg") if split else Replicate())
            elif a == "model" and experts_summed and "experts" in path:
                out.append(Partial("sum"))
            else:
                out.append(Replicate())
        return out

    def reduce(grads: dict, params: dict, split: bool) -> dict:
        def one(path, g, p):
            src = DTensor.from_local(g, mesh, grad_placements(path, split), run_check=False)
            return src.redistribute(mesh, p.placements).to_local()

        return _map_paths(one, grads, params)

    def norm_of(grads: dict, params: dict) -> torch.Tensor:
        """The global norm of the reduced gradient: each block's squares
        over the number of ranks holding it, summed over every rank."""
        total = 0
        for g, p in zip(tree_leaves(grads), tree_leaves(params)):
            copies = math.prod(mesh.shape[i] for i, pl in enumerate(p.placements)
                               if isinstance(pl, Replicate))
            total = total + g.detach().float().square().sum() / copies
        for i in range(mesh.ndim):
            dist.all_reduce(total, group=mesh.get_group(i))
        return torch.sqrt(total)

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        params, opt = state["params"], state["opt"]
        rows = batch["tokens"].shape[0] // microbatches
        split = n_dp > 1 and rows % n_dp == 0
        if not split and n_dp > 1 and experts_summed:
            raise ValueError(f"the expert-parallel MoE needs each microbatch's {rows} rows "
                             f"split over the data axes {dp} ({n_dp})")
        local = rows // n_dp if split else rows
        scale = n_dp if split else 1
        total, metrics = None, []
        with gathered(skeleton, params) as model, set_mesh(mesh), \
                (split_batch(dp) if split else contextlib.nullcontext()):
            for i in range(microbatches):
                mb = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
                counts = ((mb["targets"] >= 0).sum().clamp(min=1),
                          (mb["targets"][:, 1:] >= 0).sum().clamp(min=1))
                if split:
                    mb = {k: v[dp_index * local:(dp_index + 1) * local] for k, v in mb.items()}
                grads, m = _grads(model, cfg, mb, remat, counts=counts, scale=scale)
                grads = tree_map(lambda g: g.float(), grads)
                total = grads if total is None else tree_map(torch.add, total, grads)
                metrics.append(m)
        total = tree_map(lambda g: g / microbatches, total)
        metrics = {k: torch.stack([m[k] for m in metrics]).mean() for k in metrics[0]}
        if split:  # the shards' cross-entropies add up to the global one
            ces = [k for k in ("ce", "mtp_ce") if k in metrics]
            for k, a in itertools.product(ces, dp):
                dist.all_reduce(metrics[k], group=mesh.get_group(a))
            mtp = metrics.get("mtp_ce", 0.0)
            metrics["loss"] = metrics["ce"] + metrics["aux"] + MTP_WEIGHT * mtp
        grads = reduce(total, params, split)
        local_opt = {"m": _local(opt["m"]), "v": _local(opt["v"]),
                     "step": opt["step"].to_local()}
        new_params, new_opt, opt_metrics = adamw_update(
            opt_cfg, grads, local_opt, _local(params), gnorm=norm_of(grads, params))
        metrics.update(opt_metrics)
        like = {"params": params, "opt": opt}
        new = {"params": new_params, "opt": new_opt}
        return _map_paths(_as_like, new, like), metrics

    return train_step


@contextlib.contextmanager
def gathered(model: LM, params: dict) -> Iterator[LM]:
    """``model``, a ``meta`` module built once with its step, holding for
    the body the full parameters gathered from a tree of ``DTensor``
    blocks (a collective on every rank); its own ``meta`` parameters are
    put back on exit, so the gathered ones live no longer than the body."""
    own = model.state_dict(keep_vars=True)
    model.load_state_dict({".".join(path): t.full_tensor() for path, t in _paths(params)},
                          assign=True)
    try:
        yield model
    finally:
        model.load_state_dict(own, assign=True)


@torch.no_grad()
def _as_like(path, t: torch.Tensor, like: DTensor) -> DTensor:
    """``t`` as a block of a ``DTensor`` placed as ``like``."""
    return DTensor.from_local(t, like.device_mesh, like.placements, run_check=False,
                              shape=like.shape, stride=like.stride())


def _paths(tree, prefix: tuple = ()) -> list[tuple[tuple, object]]:
    if isinstance(tree, dict):
        return [pair for k, v in tree.items() for pair in _paths(v, prefix + (k,))]
    return [(prefix, tree)]


def _map_paths(fn: Callable, tree, *rest, prefix: tuple = ()):
    """``fn(path, leaf, *leaves of rest at the path)`` over ``tree``."""
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, *(r[k] for r in rest), prefix=prefix + (k,))
                for k, v in tree.items()}
    return fn(prefix, tree, *rest)


def _local(tree: dict) -> dict:
    return tree_map(lambda t: t.to_local(), tree)
