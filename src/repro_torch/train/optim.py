"""AdamW with configurable moment dtypes and global-norm clipping.

The port's counterpart of ``repro/train/optim.py``.  Moments can be
stored in bf16 (half the optimizer memory); all math runs in fp32 and
the states are cast on read and write.  Parameters, gradients and the
moments are *trees*: nested dicts of tensors whose keys mirror the
parameter names (:func:`param_tree` of a model gives ``{"embed":
{"table": ...}, "layers": {"0": {"attn": {"wq": {"w": ...}}}}, ...}``),
so a moment sits at its parameter's path.  The update is elementwise
but for the global norm, so the sharded train step
(:func:`repro_torch.train.step.make_train_step` with ``mesh=``) runs it
on each rank's blocks of the parameters and moments (the reference's
ZeRO sharding), with the norm summed over the shards.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Mapping

import torch
from torch import nn

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "global_norm",
    "nest",
    "param_tree",
    "schedule",
    "tree_leaves",
    "tree_map",
]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "bfloat16"  # m/v storage dtype
    warmup_steps: int = 100
    total_steps: int = 10_000


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the same paths of ``rest``),
    keeping the nesting."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """The leaves in sorted-key order (as ``jax.tree_util`` flattens a dict)."""
    if isinstance(tree, Mapping):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def nest(flat: Mapping) -> dict:
    """``{"a.b.c": t}`` -> ``{"a": {"b": {"c": t}}}``."""
    out: dict = {}
    for name, t in flat.items():
        node = out
        *path, leaf = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = t
    return out


def param_tree(params: nn.Module | Mapping) -> dict:
    """The model's parameters as a nested dict keyed by the parts of their
    names (the tensors themselves, not copies); a tree passes through."""
    if isinstance(params, Mapping):
        return dict(params)
    return nest(dict(params.named_parameters()))


def schedule(cfg: AdamWConfig, step: torch.Tensor | int) -> torch.Tensor:
    """Linear warmup + cosine decay to 10 %, in float32 (a 0-d tensor on
    ``step``'s device)."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.55 + 0.45 * torch.cos(math.pi * frac)
    return cfg.lr * warm * cos


def adamw_init(cfg: AdamWConfig, params: nn.Module | Mapping) -> dict:
    """Zero moments in ``cfg.moment_dtype`` at every parameter's path, and
    ``step`` 0 (int32), on the parameters' device."""
    dt = getattr(torch, cfg.moment_dtype)
    tree = param_tree(params)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)  # noqa: E731
    device = tree_leaves(tree)[0].device
    return {"m": tree_map(zeros, tree), "v": tree_map(zeros, tree),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32."""
    return torch.sqrt(sum(x.detach().float().square().sum() for x in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(
    cfg: AdamWConfig, grads: Any, state: dict, params: Any,
    *, gnorm: torch.Tensor | None = None,
) -> tuple[Any, dict, dict]:
    """Returns ``(new_params, new_state, metrics)``: new tensors, the inputs
    untouched.  The gradient is clipped to ``clip_norm`` by its global
    norm (``metrics["grad_norm"]`` is the norm before clipping):
    :func:`global_norm` of ``grads`` unless ``gnorm`` gives it (the
    sharded step, whose ``grads`` are one rank's blocks)."""
    params = param_tree(params)
    step = state["step"] + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = schedule(cfg, step)
    stepf = step.float()
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, device=stepf.device), stepf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, device=stepf.device), stepf)
    dt = getattr(torch, cfg.moment_dtype)

    def upd(g, m, v, p):
        g = g.float() * scale
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
        delta = (m32 / b1c) / (torch.sqrt(v32 / b2c) + cfg.eps)
        delta = delta + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m32.to(dt), v32.to(dt)

    out = tree_map(upd, grads, state["m"], state["v"], params)
    pick = lambda i: tree_map(lambda t: t[i], out)  # noqa: E731
    return (pick(0), {"m": pick(1), "v": pick(2), "step": step},
            {"grad_norm": gnorm, "lr": lr})
