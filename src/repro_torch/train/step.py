"""Train step: loss, gradients, AdamW.

The port's counterpart of ``repro/train/step.py``.
``make_train_step(cfg, opt_cfg, microbatches=N)`` builds a step that
accumulates gradients over N microbatches (activation memory follows
the microbatch; one optimizer update per global batch), as the
reference's ``lax.scan`` does.  The gradients come from autograd through
:func:`repro_torch.models.forward_train`, whose kernels (K4, K6, K7) are
entered through their ``torch.autograd.Function`` s.

The port trains on one device: the reference's ``logits_sharding`` (a
layout pin for the vocab axis under a mesh) has no counterpart and is
left out, and the data-parallel gradient mean waits for the port's
``parallel/``.  The state is ``{"params": model, "opt": tree}``: the
model (an ``nn.Module``) is updated in place, the optimizer tree
(:func:`repro_torch.train.optim.adamw_init`) replaced by the new one.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..models import forward_train, init_params
from ..models.config import ModelConfig
from ..models.model import LM
from .optim import AdamWConfig, adamw_init, adamw_update, nest, param_tree, tree_map

__all__ = [
    "MTP_WEIGHT",
    "TrainState",
    "loss_fn",
    "make_train_step",
    "softmax_xent",
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


def softmax_xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over non-negative targets (-1 = padding), in
    fp32: ``logsumexp - picked logit`` averaged over the valid targets."""
    valid = targets >= 0
    safe = targets.clamp(min=0).long()
    lf = logits.float()
    logz = torch.logsumexp(lf, dim=-1)
    picked = torch.gather(lf, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, logz - picked, torch.zeros_like(logz))
    return nll.sum() / valid.sum().clamp(min=1)


def train_state_init(
    generator: torch.Generator, cfg: ModelConfig, opt_cfg: AdamWConfig
) -> TrainState:
    """Random parameters (:func:`repro_torch.models.init_params`) and zero
    optimizer moments."""
    params = init_params(generator, cfg)
    return TrainState(params=params, opt=adamw_init(opt_cfg, params))


def loss_fn(
    params: LM, cfg: ModelConfig, batch: dict, *, remat: bool = True
) -> tuple[torch.Tensor, dict]:
    """``(loss, metrics)``: cross-entropy on ``batch["targets"]`` plus the
    MoE aux loss, plus ``MTP_WEIGHT`` times the MTP head's cross-entropy
    on the targets one position on (where the model has the head)."""
    logits, aux, mtp_logits = forward_train(params, cfg, batch, remat=remat)
    ce = softmax_xent(logits, batch["targets"])
    loss = ce + aux
    metrics = {"ce": ce, "aux": aux}
    if mtp_logits is not None:
        # MTP predicts token t+2: logits index i <-> target index i+1
        mtp_ce = softmax_xent(mtp_logits, batch["targets"][:, 1:])
        loss = loss + MTP_WEIGHT * mtp_ce
        metrics["mtp_ce"] = mtp_ce
    metrics["loss"] = loss
    return loss, metrics


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: AdamWConfig,
    *,
    microbatches: int = 1,
    remat: bool = True,
) -> Callable:
    """Returns ``train_step(state_dict, batch) -> (state_dict, metrics)``.

    ``state_dict`` is ``{"params": model, "opt": tree}``
    (:meth:`TrainState.as_dict`); the model's parameters are overwritten
    with the updated ones and the returned dict holds the new optimizer
    tree.  With ``microbatches > 1`` the batch's leading dim is split,
    and the gradients of the parts are summed in fp32 and divided by
    their number.  Metrics are 0-d tensors (the microbatches' mean)."""

    def grads_of(params: LM, batch: dict) -> tuple[dict, dict]:
        names, leaves = zip(*params.named_parameters())
        for p in leaves:
            p.requires_grad_(True)
        loss, metrics = loss_fn(params, cfg, batch, remat=remat)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        return nest(dict(zip(names, grads))), {k: v.detach() for k, v in metrics.items()}

    def accumulated(params: LM, batch: dict) -> tuple[dict, dict]:
        parts = {k: v.chunk(microbatches, dim=0) for k, v in batch.items()}
        total, metrics = None, []
        for i in range(microbatches):
            grads, m = grads_of(params, {k: v[i] for k, v in parts.items()})
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
            grads, metrics = grads_of(params, batch)
        new_params, new_opt, opt_metrics = adamw_update(opt_cfg, grads, opt, params)
        with torch.no_grad():
            tree_map(lambda p, new: p.copy_(new), param_tree(params), new_params)
        metrics.update(opt_metrics)
        return {"params": params, "opt": new_opt}, metrics

    return train_step
