"""One rank of the port's multi-rank checks on the CPU (``gloo``).

Run by ``tests/test_torch_parallel.py``, ``tests/test_torch_partition.py``
and ``tests/test_torch_launch_train.py``, one process per rank::

    python tests/torch_parallel_ranks.py TASK RANK WORLD DIR

The ranks rendezvous through a ``FileStore`` in DIR, read their inputs
from DIR (numpy files the test wrote) and write their outputs there
(``torch.save``).  This module imports the port only, never jax.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.backend import set_backend
from repro_torch.obs import clock
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_reference_params
from repro_torch.launch import train as launch
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import prefill
from repro_torch.models.ffn import MoE, drop_counts, reset_drop_counts
from repro_torch.models.moe_sharded import moe_apply_sharded, moe_route_sharded
from repro_torch.launch import specs
from repro_torch.parallel import gather_state, set_mesh, shard, split_batch
from repro_torch.parallel import partition
from repro_torch.parallel.sharding import (batch_sharding, cache_sharding, local_block,
                                          param_sharding, shard_state)
from repro_torch.train import (AdamWConfig, TrainState, adamw_init, make_train_step,
                               train_state_init)
from repro_torch.train.optim import param_tree
from repro_torch.train.compress import init_error_state, make_compressed_grad_fn
from repro_torch.train.step import shard_train_state, state_sharding

# the sharded train step's cases: arch, MoE (dispatch, capacity factor,
# aux coefficient), batch rows, sequence, microbatches, mesh (each held
# against the port's own single-device step by the test).  Under
# "shard_map" the aux loss is the data shards' local estimates averaged,
# as the reference's, which is not the whole batch's: its coefficient is
# 0 where the data axis splits the batch, and the (1, 4) case holds the
# aux gradient through the model axis
STEP_CASES = {
    "dense": ("qwen1.5-4b", None, 8, 16, 1, (2, 2)),
    "dense_microbatches": ("qwen1.5-4b", None, 8, 16, 2, (2, 2)),
    "dense_replicated_batch": ("qwen1.5-4b", None, 3, 16, 1, (2, 2)),
    "moe_gspmd_drops": ("qwen3-moe-235b-a22b", ("gspmd", 1.0, 0.001), 8, 16, 2, (2, 2)),
    "moe_shard_map": ("qwen3-moe-235b-a22b", ("shard_map", 4.0, 0.0), 8, 16, 1, (2, 2)),
    "moe_shard_map_tp4": ("qwen3-moe-235b-a22b", ("shard_map", 4.0, 0.001), 4, 16, 1,
                          (1, 4)),
    "mla_moe_mtp": ("deepseek-v3-671b", ("gspmd", 1.0, 0.001), 4, 16, 1, (2, 2)),
}
STEPS = 2
OPT = dict(lr=1e-2, warmup_steps=1, eps=1.0, moment_dtype="float32")
MOE_CASES = {"cf1": 1.0, "cf4": 4.0}


def step_config(name: str):
    arch, moe = STEP_CASES[name][:2]
    cfg = get_smoke_config(arch)
    if moe is not None:
        dispatch, cf, coef = moe
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch=dispatch, capacity_factor=cf, router_aux_coef=coef))
    return cfg


def step_batch(name: str, vocab: int) -> dict:
    """Seeded tokens and targets, the targets padded (-1) unevenly: most
    of all in the first rows (the first data shard's)."""
    b, s = STEP_CASES[name][2:4]
    rng = np.random.default_rng(7)
    toks = rng.integers(0, vocab, (b, s + 1))
    targets = toks[:, 1:].copy()
    for row in range(b):
        targets[row, s - max(0, s // 2 - 3 * row):] = -1
    return {"tokens": torch.from_numpy(toks[:, :-1].copy()),
            "targets": torch.from_numpy(targets)}


def initial_state(cfg):
    return train_state_init(torch.Generator().manual_seed(3), cfg, AdamWConfig(**OPT))


def _task_train_step(out: str) -> None:
    meshes = {}
    results = {}
    for name in STEP_CASES:
        shape = STEP_CASES[name][5]
        mesh = meshes.setdefault(shape, make_mesh(shape, ("data", "model"), "cpu"))
        cfg = step_config(name)
        state = shard_train_state(mesh, initial_state(cfg))
        step = make_train_step(cfg, AdamWConfig(**OPT), microbatches=STEP_CASES[name][4],
                               mesh=mesh)
        batch = step_batch(name, cfg.vocab)
        metrics = []
        for _ in range(STEPS):
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        full = gather_state(state)
        results[name] = {"metrics": metrics, "params": full["params"],
                         "m": full["opt"]["m"]}
    if dist.get_rank() == 0:
        torch.save(results, os.path.join(out, "train_step.pt"))


def _moe_module(cfg, arrays: dict) -> MoE:
    p = MoE(cfg, device="cpu")
    with torch.no_grad():
        p.router.w.copy_(torch.from_numpy(arrays["router"]))
        for k in ("wi_gate", "wi_up", "wo"):
            getattr(p.experts, k).copy_(torch.from_numpy(arrays[k]))
    return p


def _task_moe(out: str) -> None:
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    arrays = dict(np.load(os.path.join(out, "moe_inputs.npz")))
    x = torch.from_numpy(arrays["x"])
    b_loc = x.shape[0] // 2
    d = mesh.get_local_rank("data")
    x_loc = x[d * b_loc:(d + 1) * b_loc]
    results = {}
    for name, cf in MOE_CASES.items():
        cfg = get_smoke_config("qwen3-moe-235b-a22b")
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch="shard_map", capacity_factor=cf))
        p = _moe_module(cfg, arrays)
        with set_mesh(mesh), split_batch(("data",)):
            y, aux = moe_apply_sharded(p, cfg, x_loc, mesh)
        r = moe_route_sharded(p, cfg, x_loc, mesh)
        results[name] = {"y": y, "aux": aux, "keep": r["keep"], "mine": r["mine"]}
    torch.save(results, os.path.join(out, f"moe_rank{dist.get_rank()}.pt"))


def _task_compress(out: str) -> None:
    mesh = make_mesh((4,), ("data",), "cpu")
    arrays = dict(np.load(os.path.join(out, "compress_inputs.npz")))
    xs, ys = torch.from_numpy(arrays["xs"]), torch.from_numpy(arrays["ys"])

    def grad_fn(w, batch):
        x, y = batch
        w = w.detach().requires_grad_(True)
        return torch.autograd.grad(((x @ w - y) ** 2).mean(), w)[0]

    w = torch.zeros(16)
    fn = make_compressed_grad_fn(grad_fn, mesh)
    err = init_error_state(w)
    g, err = fn(w, (xs, ys), err)
    first = {"g": g, "err": err}
    for _ in range(300):
        g_i, err = fn(w, (xs, ys), err)
        w = w - 0.1 * g_i
    torch.save({"first": first, "w": w}, os.path.join(out, f"compress_rank{dist.get_rank()}.pt"))


def _task_elastic(out: str) -> None:
    mesh_a = make_mesh((2, 2), ("data", "model"), "cpu")
    mesh_b = make_mesh((4, 1), ("data", "model"), "cpu")
    cfg = get_smoke_config("qwen1.5-4b")
    state = train_state_init(torch.Generator().manual_seed(5), cfg, AdamWConfig())
    tree = state.tree()
    placed = shard_train_state(mesh_a, state)
    ckpt = os.path.join(out, "elastic")
    save_checkpoint(ckpt, 1, placed)
    specs_b = state_sharding(mesh_b, tree)
    restored = restore_checkpoint(ckpt, 1, placed, shardings=(mesh_b, specs_b))
    same = []
    flat = list(_paths(tree))
    got = dict(_paths(restored))
    specs = dict(_paths(specs_b))
    for path, full in flat:
        r = got[path]
        same.append(r.device_mesh is mesh_b and r.dtype == full.dtype
                    and torch.equal(_bits(r.to_local()),
                                    _bits(local_block(mesh_b, full, specs[path])))
                    and torch.equal(_bits(r.full_tensor()), _bits(full)))
    torch.save({"leaves": len(flat), "identical": sum(same)},
               os.path.join(out, f"elastic_rank{dist.get_rank()}.pt"))


def _task_constrain(out: str) -> None:
    """``shard`` lays a DTensor out on the ambient mesh's logical spec (an
    axis that does not divide its dim replicates); the identity with no
    mesh and on a plain tensor."""
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    full = torch.arange(48.0).reshape(8, 6)
    dt = distribute_tensor(full, mesh, [Replicate(), Replicate()])
    odd = distribute_tensor(torch.arange(18.0).reshape(3, 6), mesh, [Replicate(), Replicate()])
    plain = torch.ones(4)
    checks = {"identity_without_mesh": shard(dt, "dp", "model") is dt}
    with set_mesh(mesh):
        laid = shard(dt, "dp", "model")
        guarded = shard(odd, "dp", "model")
        checks.update(
            identity_on_plain=shard(plain, "dp") is plain,
            placements=list(laid.placements) == [Shard(0), Shard(1)],
            values=torch.equal(laid.full_tensor(), full),
            block=torch.equal(laid.to_local(), local_block(mesh, full, ("data", "model"))),
            guard=list(guarded.placements) == [Replicate(), Shard(1)])
    torch.save(checks, os.path.join(out, f"constrain_rank{dist.get_rank()}.pt"))


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    else:
        yield prefix, tree


def _task_launch(out: str) -> None:
    """The driver's sharded loop: 3 steps on (2, 2), then resumed onto
    (4, 1) to 5; and ``--production-mesh`` in this world of 4."""
    flags = ["--smoke", "--arch", "qwen1.5-4b", "--seq-len", "16", "--batch", "4",
             "--device", "cpu", "--ckpt-dir", os.path.join(out, "ckpt")]
    losses = []
    for shape, steps in (((2, 2), 3), ((4, 1), 5)):
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        losses += launch.train(launch.parse_args([*flags, "--steps", str(steps)]), mesh)
    try:
        launch.main([*flags, "--steps", "1", "--production-mesh"])
        refused = ""
    except RuntimeError as e:
        refused = str(e)
    torch.save({"losses": losses, "refused": refused},
               os.path.join(out, f"launch_rank{dist.get_rank()}.pt"))


# the partitioned step's cases (``tests/test_torch_partition.py``): smoke
# arch, config overrides (None: the smoke config), mesh and the MoE's
# (dispatch, capacity factor, aux coefficient[, experts]).  qwen1.5-4b's 4
# heads divide both model extents; 5 heads divide neither (attention
# replicated on model); qwen2.5-32b's 2 KV heads on 4 are shared by two
# ranks each; qwen3-32b adds the per-head norms; llava the patch prefix.
# The MoE cases: Qwen3-MoE's 2 KV heads on 4 shared, its experts split on
# model; under "gspmd" at capacity factor 1.1 the global capacity (35 of
# 128 tokens x 2) drops assignments and does not divide the 2 data shards
# (rows padded); 5 experts divide neither the data extent nor the model
# extent (experts whole on model); "shard_map" at (1, 4); DeepSeek-V3's
# MLA by heads (2 on 2, 1 on 4), its shared expert and the MTP head.  The
# SSM cases: Mamba2's and Zamba2's 8 SSD heads and 296 in_proj columns
# split on both extents (Zamba2's shared block by heads, used twice); at
# d_model 48, Mamba2's 6 heads and 230 in_proj columns divide neither by 4
# (the mixer replicated on model, in_proj whole there, as mamba2-130m's on
# 16)
PARTITION_CASES = {
    "dense_2x2": ("qwen1.5-4b", None, (2, 2), None),
    "dense_1x4": ("qwen1.5-4b", None, (1, 4), None),
    "odd_heads_2x2": ("qwen1.5-4b", {"n_heads": 5, "n_kv_heads": 5}, (2, 2), None),
    "odd_heads_1x4": ("qwen1.5-4b", {"n_heads": 5, "n_kv_heads": 5}, (1, 4), None),
    "shared_kv_1x4": ("qwen2.5-32b", None, (1, 4), None),
    "qk_norm_1x4": ("qwen3-32b", None, (1, 4), None),
    "vlm_2x2": ("llava-next-mistral-7b", None, (2, 2), None),
    "moe_2x2": ("qwen3-moe-235b-a22b", None, (2, 2), ("gspmd", 1.1, 0.001)),
    "moe_1x4": ("qwen3-moe-235b-a22b", None, (1, 4), ("gspmd", 1.0, 0.001)),
    "odd_experts_2x2": ("qwen3-moe-235b-a22b", None, (2, 2), ("gspmd", 1.0, 0.001, 5)),
    "moe_shard_map_1x4": ("qwen3-moe-235b-a22b", None, (1, 4), ("shard_map", 4.0, 0.001)),
    "mla_moe_2x2": ("deepseek-v3-671b", None, (2, 2), ("gspmd", 1.0, 0.001)),
    "mla_moe_1x4": ("deepseek-v3-671b", None, (1, 4), ("gspmd", 1.0, 0.001)),
    "mamba2_2x2": ("mamba2-130m", None, (2, 2), None),
    "mamba2_1x4": ("mamba2-130m", None, (1, 4), None),
    "mamba2_replicated_1x4": ("mamba2-130m", {"d_model": 48}, (1, 4), None),
    "zamba2_2x2": ("zamba2-2.7b", None, (2, 2), None),
    "zamba2_1x4": ("zamba2-2.7b", None, (1, 4), None),
}
PREFILL_LEN = 12
# the SSM cases, run by a rank group of their own (task partition_ssm)
SSM_CASES = tuple(n for n, c in PARTITION_CASES.items() if c[0] in ("mamba2-130m", "zamba2-2.7b"))
BASE_CASES = tuple(n for n in PARTITION_CASES if n not in SSM_CASES)


def partition_config(name: str):
    arch, overrides, _, moe = PARTITION_CASES[name]
    cfg = dataclasses.replace(get_smoke_config(arch), **(overrides or {}))
    if moe is not None:
        dispatch, cf, coef, *experts = moe
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch=dispatch, capacity_factor=cf, router_aux_coef=coef,
            n_experts=experts[0] if experts else cfg.moe.n_experts))
    return cfg


def partition_batch(cfg) -> dict:
    """The dense cases' batch (``step_batch``), with llava's seeded patch
    prefix."""
    batch = step_batch("dense", cfg.vocab)
    if cfg.block_pattern == "vlm":
        rng = np.random.default_rng(9)
        batch["patches"] = torch.from_numpy(
            rng.standard_normal((8, cfg.n_patches, cfg.d_model)).astype(np.float32))
    return batch


def reference_state(out: str, cfg, name: str = "ref_init"):
    """The reference's initial parameters (``{name}.npz``, written by the
    test) in the port's model, and zero moments."""
    arrays = dict(np.load(os.path.join(out, f"{name}.npz")))
    tree: dict = {}
    for key, value in arrays.items():
        node = tree
        *parents, leaf = key.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = value
    params = from_reference_params(tree, cfg)
    return TrainState(params, adamw_init(AdamWConfig(**OPT), params))


def _train_run(mesh, cfg, state, batch, count_flops: bool) -> dict:
    placed = shard_train_state(mesh, state)
    step = make_train_step(cfg, AdamWConfig(**OPT), mesh=mesh)
    metrics, flops = [], None
    for i in range(STEPS):
        counter = FlopCounterMode(display=False)
        with counter if count_flops and i == 0 else contextlib.nullcontext():
            placed, m = step(placed, batch)
        if count_flops and i == 0:
            flops = counter.get_total_flops()
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "params": gather_state(placed)["params"], "flops": flops}


# the cases held against the reference's jitted sharded steps on (2, 2),
# each from the reference's initial parameters (``ref_init_{case}.npz``)
REFERENCE_CASES = ("dense_2x2", "moe_2x2", "mla_moe_2x2", "mamba2_2x2", "zamba2_2x2")


def _task_partition(out: str, cases: tuple) -> None:
    """The partitioned train step on each of ``cases``, 2 steps (rank 0
    saves the gathered state and each rank its first step's FLOPs); the
    partitioned prefill (each rank saves its split logits and its cache:
    KV heads, MLA's latent, or a Mamba2 state); the same step from the
    reference's initial parameters on (2, 2) for those of REFERENCE_CASES."""
    meshes: dict = {}
    results: dict = {"flops": {}, "prefill": {}}
    rank = dist.get_rank()
    for name in cases:
        shape = PARTITION_CASES[name][2]
        mesh = meshes.setdefault(shape, make_mesh(shape, ("data", "model"), "cpu"))
        cfg = partition_config(name)
        batch = partition_batch(cfg)
        run = _train_run(mesh, cfg, initial_state(cfg), batch, count_flops=True)
        results["flops"][name] = run.pop("flops")
        results[name] = run
        model = initial_state(cfg).params
        params = shard_state(mesh, param_tree(model), param_sharding(mesh, model))
        prompt = {k: v[:, :PREFILL_LEN] for k, v in batch.items() if k != "targets"}
        if "patches" in batch:
            prompt["patches"] = batch["patches"]
        placed = shard_state(mesh, prompt, batch_sharding(mesh, prompt))
        reset_drop_counts()
        logits, cache = specs._partitioned_prefill(cfg, mesh)(params, placed)
        results["prefill"][name] = {"logits": logits, "pos": cache["pos"], **cache["layers"],
                                    "attention": partition.attention_mode(cfg, mesh.shape[1]),
                                    "drops": drop_counts()}
    for name in (n for n in REFERENCE_CASES if n in cases):
        cfg = partition_config(name)
        results[f"reference/{name}"] = _train_run(
            meshes[(2, 2)], cfg, reference_state(out, cfg, f"ref_init_{name}"),
            partition_batch(cfg), count_flops=False)
    torch.save(results if rank == 0 else {"flops": results["flops"],
                                          "prefill": results["prefill"]},
               os.path.join(out, f"partition_rank{rank}.pt"))


# the partitioned decode's inputs (``tests/test_torch_partition.py``): each
# case's prompt is prefilled on one device into a cache of
# ``decode_len`` positions (the prompt and 4 more, a multiple of 4), whose
# rows are then set back to positions spread over it (``decode_pos``), so
# that the rows write into different ranks' shards, one crossing from a
# shard into the next; DECODE_STEPS seeded tokens are fed in turn
DECODE_STEPS = 4
DECODE_POS = (7, 0, 3, 5, 2, 7, 4, 1)  # sevenths of the last start position
# the cases whose partition factor is held against XLA's, on both meshes
FACTOR_CASES = ("dense_2x2", "dense_1x4", "moe_2x2", "moe_1x4", "mla_moe_2x2", "mla_moe_1x4",
                "mamba2_2x2", "mamba2_1x4", "mamba2_replicated_1x4", "zamba2_2x2", "zamba2_1x4")


def decode_len(cfg) -> int:
    prompt = PREFILL_LEN + (cfg.n_patches if cfg.block_pattern == "vlm" else 0)
    return -(-(prompt + DECODE_STEPS) // 4) * 4


def decode_inputs(cfg) -> tuple[dict, torch.Tensor, torch.Tensor]:
    """The prompt (``partition_batch``'s first PREFILL_LEN tokens, and the
    VLM's patches), the rows' positions (B,) int32 and the tokens (B,
    DECODE_STEPS) fed one a step."""
    batch = partition_batch(cfg)
    prompt = {k: v[:, :PREFILL_LEN] for k, v in batch.items() if k != "targets"}
    if "patches" in batch:
        prompt["patches"] = batch["patches"]
    last = decode_len(cfg) - DECODE_STEPS
    pos = torch.tensor([last * k // 7 for k in DECODE_POS], dtype=torch.int32)
    rng = np.random.default_rng(11)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (len(DECODE_POS), DECODE_STEPS)))
    return prompt, pos, tokens


def single_prefill(params, cfg, prompt: dict, pos: torch.Tensor, length: int | None = None) -> dict:
    """The one-device cache of ``length`` positions (default
    ``decode_len``) the partitioned decode starts from."""
    _, cache = prefill(params, cfg, prompt, max_len=length or decode_len(cfg))
    cache["pos"] = pos.clone()
    return cache


def _decode_run(mesh, cfg, params, prompt, pos, tokens, count_flops: bool = False,
                length: int | None = None) -> dict:
    """DECODE_STEPS partitioned decode steps (``step_fn_for``'s
    ``_partitioned_decode``) from the one-device prefill's cache, cut by
    ``cache_sharding``: each step's logits and the final cache blocks."""
    cache = single_prefill(params, cfg, prompt, pos, length)
    placed = shard_state(mesh, cache, cache_sharding(mesh, cache))
    blocks = shard_state(mesh, param_tree(params), param_sharding(mesh, params))
    step = specs._partitioned_decode(cfg, mesh)
    logits, flops = [], None
    for i in range(DECODE_STEPS):
        tok = {"tokens": tokens[:, i:i + 1]}
        tok = shard_state(mesh, tok, batch_sharding(mesh, tok))["tokens"]
        counter = FlopCounterMode(display=False)
        with counter if count_flops and i == 0 else contextlib.nullcontext():
            out, placed = step(blocks, tok, placed)
        if count_flops and i == 0:
            flops = counter.get_total_flops()
        logits.append(out)
    return {"logits": logits, "pos": placed["pos"].to_local(), "flops": flops,
            **_locals(placed["layers"])}


def _locals(tree: dict) -> dict:
    """The local blocks of a tree of ``DTensor`` s, nested as it is."""
    return {k: _locals(v) if isinstance(v, dict) else v.to_local() for k, v in tree.items()}


# the partitioned decode over the K/V layouts cache_sharding gives where
# the sequence does not lie on model: arch, mesh, cache length and the
# rows' positions.  63 positions on (2, 2) or (1, 4): the KV heads on
# model, the rows on data; 3 rows on (2, 2): the rows whole, the sequence
# on data (the first row's steps cross from one shard into the next), the
# heads on model
LAYOUT_CASES = {
    "dense_heads_2x2": ("qwen1.5-4b", (2, 2), 63, (59, 0, 25, 42, 17, 34, 8, 50)),
    "dense_sequence_on_data_2x2": ("qwen1.5-4b", (2, 2), 64, (30, 0, 60)),
    "zamba2_heads_1x4": ("zamba2-2.7b", (1, 4), 63, (59, 0, 25, 42, 17, 34, 8, 50)),
    "zamba2_sequence_on_data_2x2": ("zamba2-2.7b", (2, 2), 64, (30, 0, 60)),
}


def layout_inputs(name: str) -> tuple:
    """A layout case's config, prompt (``partition_batch``'s first rows),
    positions, tokens (one a step) and cache length."""
    arch, _, length, positions = LAYOUT_CASES[name]
    cfg = get_smoke_config(arch)
    rows = len(positions)
    prompt = {"tokens": partition_batch(cfg)["tokens"][:rows, :PREFILL_LEN]}
    rng = np.random.default_rng(13)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (rows, DECODE_STEPS)))
    return cfg, prompt, torch.tensor(positions, dtype=torch.int32), tokens, length


def _task_partition_decode(out: str, cases: tuple, layouts: tuple = ()) -> None:
    """The partitioned decode on each of ``cases`` (each rank saves its
    split logits, its cache blocks and, for FACTOR_CASES, its first step's
    FLOPs), on (2, 2) from the reference's initial parameters for those
    of REFERENCE_CASES, and on the ``layouts`` of LAYOUT_CASES."""
    meshes: dict = {}
    results: dict = {}
    for name in cases:
        shape = PARTITION_CASES[name][2]
        mesh = meshes.setdefault(shape, make_mesh(shape, ("data", "model"), "cpu"))
        cfg = partition_config(name)
        results[name] = _decode_run(mesh, cfg, initial_state(cfg).params, *decode_inputs(cfg),
                                    count_flops=name in FACTOR_CASES)
    for name in (n for n in REFERENCE_CASES if n in cases):
        cfg = partition_config(name)
        results[f"reference/{name}"] = _decode_run(
            meshes[(2, 2)], cfg, reference_state(out, cfg, f"ref_init_{name}").params,
            *decode_inputs(cfg))
    for name in layouts:
        shape = LAYOUT_CASES[name][1]
        cfg, prompt, pos, tokens, length = layout_inputs(name)
        mesh = meshes.setdefault(shape, make_mesh(shape, ("data", "model"), "cpu"))
        results[f"layout/{name}"] = _decode_run(mesh, cfg, initial_state(cfg).params, prompt,
                                                pos, tokens, length=length)
    torch.save(results, os.path.join(out, f"partition_decode_rank{dist.get_rank()}.pt"))


def _task_operators(out: str) -> None:
    """The model-axis operators on the (1, 4) mesh's ``model`` group, on
    the test's seeded inputs: each rank's outputs and gradients."""
    mesh = make_mesh((1, 4), ("data", "model"), "cpu")
    group, r = mesh.get_group("model"), mesh.get_local_rank("model")
    a = {k: torch.from_numpy(v) for k, v in np.load(os.path.join(out, "operators.npz")).items()}
    res = {}
    x = a["x"].clone().requires_grad_(True)
    y = partition.copy_in(x, group)
    (y * a["w"][r]).sum().backward()
    res["copy_in"], res["copy_in_grad"] = y.detach(), x.grad
    x = a["xs"][r].clone().requires_grad_(True)
    y = partition.reduce_out(x, group)
    (y * a["w"][0]).sum().backward()
    res["reduce_out"], res["reduce_out_grad"] = y.detach(), x.grad
    n = a["table"].shape[0] // 4
    table = a["table"][r * n:(r + 1) * n].clone().requires_grad_(True)
    y = partition.vocab_embed(table, a["tokens"], r * n, group)
    (y * a["c"]).sum().backward()
    res["embed"], res["embed_grad"] = y.detach(), table.grad
    n = a["logits"].shape[-1] // 4
    logits = a["logits"][..., r * n:(r + 1) * n].clone().requires_grad_(True)
    nll = partition.vocab_xent(logits, a["targets"], r * n, group)
    (nll * a["g"]).sum().backward()
    res["xent"], res["xent_grad"] = nll.detach(), logits.grad
    res["combine"] = partition.softmax_combine(a["att_out"][r], a["att_lse"][r], group)
    torch.save(res, os.path.join(out, f"operators_rank{dist.get_rank()}.pt"))


GROUP_TIMEOUT_S = 180  # a hung collective fails its test instead of the suite
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def subprocess_env() -> dict:
    """This process's environment with the repository's ``src`` on the path."""
    return {**os.environ,  # reprolint: disable=R002 passthrough to a subprocess, no backend choice read
            "PYTHONPATH": os.path.join(REPO, "src")}


def start_ranks(task: str, world: int, out) -> list:
    """``world`` processes running ``TASK`` as the ranks of one group."""
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__), task, str(r),
                              str(world), str(out)],
                             env=subprocess_env(), stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def wait_all(procs: list, timeout: float = GROUP_TIMEOUT_S) -> None:
    """Wait for every process, ``timeout`` seconds at most for them all:
    past it every one is killed and the caller fails; so does any that
    exits non-zero (its output's end in the message)."""
    deadline = clock.perf_counter() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(0.0, deadline - clock.perf_counter()))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        raise AssertionError(f"a process group hung past {timeout} s") from None
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]


TASKS = {
    "parallel": (_task_train_step, _task_moe, _task_compress, _task_elastic, _task_constrain),
    "launch": (_task_launch,),
    "partition": (_task_operators, functools.partial(_task_partition, cases=BASE_CASES),
                  functools.partial(_task_partition_decode, cases=BASE_CASES)),
    # the SSM cases and the decode layouts, a group beside the first
    "partition_ssm": (functools.partial(_task_partition, cases=SSM_CASES),
                      functools.partial(_task_partition_decode, cases=SSM_CASES,
                                        layouts=tuple(LAYOUT_CASES))),
}


def main(task: str, rank: int, world: int, out: str) -> None:
    torch.set_num_threads(1)  # the ranks share the host's cores
    store = dist.FileStore(os.path.join(out, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        with set_backend(device="cpu"):
            for fn in TASKS[task]:
                fn(out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
