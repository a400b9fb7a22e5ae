"""Abstract inputs, parameters, train state and decode cache of an
(arch, shape) cell, and the step each cell runs, one per shape kind.

The port's counterpart of ``repro/launch/specs.py``.  An abstract value
is a ``meta`` tensor of the reference's shape and dtype (its
``jax.ShapeDtypeStruct``): nothing is allocated.  :func:`param_specs` is
the model built on ``meta``, :func:`state_specs` the train state on it
(the parameters and ``adamw_init``'s zero moments) and
:func:`cache_specs` ``init_decode_cache`` on it; each builds under
``set_backend(device=device)``, ``meta`` unless the caller names a real
device (the card's check of the dry run does, and then fills the
tensors itself).  The reference's parameter tree stacks the layers; the
port keeps a module per layer (``repro_torch.convert.reference_leaf``
maps one onto the other).

:func:`step_fn_for` returns ``(fn, args)``:

- ``train``: ``make_train_step(cfg, opt_cfg, microbatches=..., mesh=mesh)``
  on the state and the global batch; with a mesh it is the port's sharded
  step, its state the blocks :func:`repro_torch.train.shard_train_state`
  would cut, its strategy the family's (``train/step.py``);
- ``prefill`` / ``decode`` with no mesh: ``prefill`` / ``decode_step``;
- ``prefill`` / ``decode`` with a mesh: the parameters sit as
  ``param_sharding`` blocks (the reference's ``shardings_for`` with
  ``serve_params=False``), the rank holds its ``batch_sharding`` rows of
  the tokens (and frames, patches) and, for decode, the cache as
  ``cache_sharding`` blocks.  The strategy is the rule's
  (:func:`repro_torch.parallel.partition.strategy`):

  - ``"partitioned"`` (every family's prefill and decode but Whisper's):
    each layer's weights gathered on the data axes in turn, the
    projections (an MoE's experts, a Mamba2 mixer's SSD heads) split on
    ``model``; the logits split on the vocabulary, as the reference's
    ``logits_sharding`` pins them
    (:class:`repro_torch.parallel.partition.Partitioned`).  Prefill
    returns the last position's logits and the cache of the rank's KV
    heads (MLA: the whole latent; Mamba2: its heads' state); decode takes
    the cache's blocks as they lie, no shard gathered, in the K/V layout
    their placements say (the sequence on ``model``: K5's partial mode,
    MLA's plain partial attention, the shards' softmaxes combined over
    ``model``; the KV heads on ``model``, the sequence whole or on
    ``data``: K5 over the rank's heads, combined over ``data`` where it
    splits the sequence), a Mamba2 state whole on ``model``, and returns
    the logits and the cache, its blocks ``DTensor`` s placed as they
    came (``pos + 1``);
  - ``"gathered"`` (Whisper's prefill and decode, and a decode whose
    cache holds its K/V head_dim on ``model``:
    :func:`repro_torch.parallel.partition.decode_strategy`): built as the
    gathered train step is, the parameters gathered whole once a step,
    the rank's own cache rows gathered whole; then ``prefill`` /
    ``decode_step`` on plain tensors under the ambient mesh, the batch
    split over the data axes as the train step splits it (so the MoE
    routes the global batch).
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..backend import set_backend
from ..configs.shapes import ShapeSpec
from ..models import decode_step, init_decode_cache, prefill
from ..models.config import ModelConfig
from ..models.model import FAMILIES, LM, check_family
from ..parallel.constrain import set_mesh, split_batch
from ..parallel.partition import (PARTITIONED, KVLayout, Partitioned, decode_strategy,
                                  kv_layout, strategy)
from ..parallel.sharding import data_shard, fsdp_axes, shard_state
from ..train import AdamWConfig, TrainState, adamw_init, make_train_step
from ..train.optim import param_tree
from ..train.step import _map_paths, _paths, gathered

__all__ = [
    "cache_specs",
    "input_specs",
    "param_specs",
    "state_specs",
    "step_fn_for",
]


def input_specs(cfg: ModelConfig, shape: ShapeSpec, *, device: str = "meta") -> dict:
    """The cell's model inputs: ``tokens`` (B, S) int32 (B, 1 for decode),
    ``targets`` for train, and outside decode encdec's ``frames`` (B,
    encoder_seq, d) and vlm's ``patches`` (B, n_patches, d) in the model's
    dtype, as the reference's."""
    b, s = shape.global_batch, shape.seq_len
    i32 = dict(dtype=torch.int32, device=device)
    if shape.kind == "train":
        batch = {"tokens": torch.zeros((b, s), **i32), "targets": torch.zeros((b, s), **i32)}
    elif shape.kind == "prefill":
        batch = {"tokens": torch.zeros((b, s), **i32)}
    elif shape.kind == "decode":
        batch = {"tokens": torch.zeros((b, 1), **i32)}
    else:
        raise ValueError(shape.kind)
    dt = dict(dtype=cfg.torch_dtype, device=device)
    if cfg.block_pattern == "encdec" and shape.kind != "decode":
        batch["frames"] = torch.zeros((b, cfg.encoder_seq, cfg.d_model), **dt)
    if cfg.block_pattern == "vlm" and shape.kind != "decode":
        batch["patches"] = torch.zeros((b, cfg.n_patches, cfg.d_model), **dt)
    return batch


def param_specs(cfg: ModelConfig, *, device: str = "meta") -> LM:
    """The model of ``cfg``'s family on ``device`` (uninitialised)."""
    check_family(cfg)
    return FAMILIES[cfg.block_pattern](cfg, device=device)


def state_specs(cfg: ModelConfig, opt_cfg: AdamWConfig, *, device: str = "meta") -> dict:
    """The train state ``{"params": model, "opt": {"m", "v", "step"}}``
    (``TrainState.as_dict()``) on ``device``."""
    params = param_specs(cfg, device=device)
    return TrainState(params, adamw_init(opt_cfg, params)).as_dict()


def cache_specs(cfg: ModelConfig, batch: int, seq: int, *, device: str = "meta",
                params: LM | None = None) -> dict:
    """``init_decode_cache`` of a populated context of ``seq`` positions for
    ``batch`` sequences, on ``device``."""
    params = param_specs(cfg, device=device) if params is None else params
    with set_backend(device=device):
        return init_decode_cache(params, cfg, batch, seq)


def step_fn_for(cfg: ModelConfig, shape: ShapeSpec, opt_cfg: AdamWConfig, *, mesh=None,
                in_shardings: tuple | None = None, microbatches: int = 1,
                device: str = "meta") -> tuple[Callable, tuple]:
    """``(fn, args)`` of the cell's step (module docstring); ``args`` on
    ``device``.  With a mesh, ``args`` are this rank's blocks placed by
    ``in_shardings``, the specs of the arguments
    (:func:`repro_torch.launch.dryrun.shardings_for`: the counterpart of
    the reference's ``jax.jit(..., in_shardings=...)``); the train step's
    batch stays whole, as the sharded step takes it and cuts its rows by
    the batch's spec itself.  Call ``fn(*args)`` under
    ``set_backend(device=device)``."""
    if mesh is not None and in_shardings is None:
        raise ValueError("step_fn_for: a mesh needs the arguments' specs (in_shardings)")
    if shape.kind == "train":
        fn = make_train_step(cfg, opt_cfg, microbatches=microbatches, mesh=mesh)
        state = state_specs(cfg, opt_cfg, device=device)
        if mesh is not None:
            state = shard_state(mesh, TrainState(**state).tree(), in_shardings[0])
        return fn, (state, input_specs(cfg, shape, device=device))
    if shape.kind not in ("prefill", "decode"):
        raise ValueError(shape.kind)
    params = param_specs(cfg, device=device)
    batch = input_specs(cfg, shape, device=device)
    if shape.kind == "decode":
        cache = cache_specs(cfg, shape.global_batch, shape.seq_len, device=device,
                            params=params)
        args = (params, batch["tokens"], cache)
    else:
        args = (params, batch)
    if mesh is None:
        if shape.kind == "prefill":
            return (lambda p, b: prefill(p, cfg, b)), args
        return (lambda p, tokens, c: decode_step(p, cfg, tokens, c)), args
    trees = (param_tree(params),) + args[1:]
    if shape.kind == "decode":  # the tokens, a bare tensor, placed as a one-leaf tree
        trees = (trees[0], {"tokens": trees[1]}, trees[2])
        in_shardings = (in_shardings[0], {"tokens": in_shardings[1]}, in_shardings[2])
    blocks = [shard_state(mesh, tree, spec) for tree, spec in zip(trees, in_shardings)]
    if shape.kind == "decode":
        blocks[1] = blocks[1]["tokens"]
    rule = (decode_strategy(cfg, mesh, in_shardings[2]) if shape.kind == "decode"
            else strategy(cfg, shape.kind))
    if rule == PARTITIONED:
        make = _partitioned_prefill if shape.kind == "prefill" else _partitioned_decode
        return make(cfg, mesh), tuple(blocks)
    return _gathered_step(cfg, shape.kind, mesh), tuple(blocks)


def _partitioned_prefill(cfg: ModelConfig, mesh) -> Callable:
    """``prefill`` of a rank that holds ``param_sharding`` blocks and its
    rows of the batch, partitioned (:class:`repro_torch.parallel.partition.
    Partitioned`): each layer's weights gathered on the data axes in
    turn, the projections split on ``model``; the last position's logits
    (B_local, 1, V / model) split on the vocabulary, and the cache of the
    rank's KV heads."""
    part = Partitioned(cfg, mesh)

    def step(params: dict, batch: dict):
        blocks = {path: t.to_local() for path, t in _paths(params)}
        split = any(isinstance(p, Shard) for p in batch["tokens"].placements)
        return part.prefill(blocks, {k: v.to_local() for k, v in batch.items()}, split=split)

    return step


def _partitioned_decode(cfg: ModelConfig, mesh) -> Callable:
    """``decode_step`` of a rank that holds ``param_sharding`` blocks, its
    rows of the tokens and ``cache_sharding`` blocks of the cache,
    partitioned (:meth:`repro_torch.parallel.partition.Partitioned.decode`):
    the logits (B_local, 1, V / model) split on the vocabulary, and the
    cache as ``DTensor`` s placed as the arguments were.  It takes the K/V
    blocks in every :class:`~repro_torch.parallel.partition.KVLayout`
    (read from their placements), MLA's latent blocks with the sequence on
    ``model``, a Mamba2 state with the rows on the data axes (or whole)
    and whole on ``model``, ``pos`` replicated; it refuses any other
    placement."""
    part = Partitioned(cfg, mesh)

    def taken(path: tuple, x: DTensor) -> bool:
        if path[-1] in ("k", "v"):
            return kv_layout(mesh, x.placements) is not None
        for axis, n, p in zip(mesh.mesh_dim_names, mesh.shape, x.placements):
            if path[-1] == "pos":
                ok = isinstance(p, Replicate)
            elif axis != "model":
                ok = p in (Shard(1), Replicate())
            elif path[-1] in ("c_kv", "k_rope"):  # (L, B, S, r)
                ok = p == Shard(2) or (n == 1 and isinstance(p, Replicate))
            else:  # a Mamba2 state (L, B, ...)
                ok = isinstance(p, Replicate)
            if not ok:
                return False
        return True

    def step(params: dict, tokens: DTensor, cache: dict):
        layout = KVLayout()
        for path, x in _paths(cache):
            if not taken(path, x):
                raise ValueError(
                    f"partitioned decode: cache leaf {'/'.join(path)} placed {x.placements}; "
                    "it takes the K/V blocks as cache_sharding lays them out, MLA's latent "
                    "blocks with the sequence on 'model', a Mamba2 state whole on 'model', "
                    "each with the rows on the data axes, pos replicated")
            if path[-1] == "k":
                layout = kv_layout(mesh, x.placements)
        blocks = {path: t.to_local() for path, t in _paths(params)}
        local = _map_paths(lambda path, x: x.to_local(), cache)
        logits, out = part.decode(blocks, tokens.to_local(), local, layout)
        return logits, _map_paths(
            lambda path, x, new: DTensor.from_local(new, mesh, x.placements, run_check=False,
                                                    shape=x.shape, stride=x.stride()),
            cache, out)

    return step


# ---- the gathered serve step -------------------------------------------------


def _gathered_step(cfg: ModelConfig, kind: str, mesh) -> Callable:
    """``prefill`` / ``decode_step`` of a rank that holds ``param_sharding``
    blocks, its rows of the batch and ``cache_sharding`` blocks of the
    cache (module docstring)."""
    dp = fsdp_axes(mesh)
    n_dp, dp_index = data_shard(mesh)
    names = mesh.mesh_dim_names
    skeleton = FAMILIES[cfg.block_pattern](cfg, device="meta")

    def rows(x: DTensor, bdim: int, split: bool) -> torch.Tensor:
        """The rank's rows of a block: every shard gathered but those of
        the batch dim ``bdim`` on the data axes; then, where the batch is
        split and this leaf's rows are not, the rank's rows taken."""
        keep = [p if isinstance(p, Shard) and p.dim == bdim and names[i] in dp else Replicate()
                for i, p in enumerate(x.placements)]
        local = x.redistribute(mesh, keep).to_local()
        if split and not any(isinstance(p, Shard) for p in keep):
            n = local.shape[bdim] // n_dp
            local = local.narrow(bdim, dp_index * n, n)
        return local

    def scope(split: bool):
        stack = contextlib.ExitStack()
        stack.enter_context(set_mesh(mesh))
        if split:
            stack.enter_context(split_batch(dp))
        return stack

    if kind == "prefill":
        def step(params: dict, batch: dict):
            split = any(isinstance(p, Shard) for p in batch["tokens"].placements)
            local = {k: v.to_local() for k, v in batch.items()}
            with gathered(skeleton, params) as model, scope(split):
                return prefill(model, cfg, local)

        return step

    def step(params: dict, tokens: DTensor, cache: dict):
        split = any(isinstance(p, Shard) for p in tokens.placements)
        local = _map_paths(lambda path, x: rows(x, _batch_dim(path), split), cache)
        with gathered(skeleton, params) as model, scope(split):
            return decode_step(model, cfg, tokens.to_local(), local)

    return step


def _batch_dim(path: tuple) -> int:
    """The batch dim of a cache leaf: 0 for ``pos`` and encdec's
    ``memory``, 1 for the per-layer leaves (L, B, ...)."""
    return 0 if path[-1] in ("pos", "memory") else 1
