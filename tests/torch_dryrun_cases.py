"""Tasks the dry-run tests run in a subprocess of their own, each in a
fake world of 256 or 512 ranks (``repro_torch.launch.dryrun.fake_world``),
so that no process group outlives its test.

Usage::

    python tests/torch_dryrun_cases.py OUT_JSON TASK [TASK ...]

writes ``{task: result}`` to ``OUT_JSON``, and the cells that ``run_cell``
writes to ``dryrun/`` beside it.  Tasks:

- ``world``: the fake world's behaviour the dry run relies on: the
  (16, 16) and (2, 16, 16) production meshes, a meta ``DTensor``'s
  gather, explicit collectives counted by ``CommDebugMode``;
- ``blocks-single``, ``blocks-multi``: rank 0's block shapes, at full
  size on the (16, 16) or the (2, 16, 16) production mesh, of every
  arch's parameters and of the batch and decode cache of every
  applicable shape, as ``step_fn_for`` places them;
- ``cells``: a small train cell's counts at rank 0 and rank 255 (full
  width, 2 layers, 16 x 64 tokens); the counts of Qwen1.5-4B's
  ``decode_32k`` at the reference's probe depths and one layer between
  them; ``run_cell`` on Qwen1.5-4B's ``decode_32k``;
- ``deepseek``: ``run_cell`` on DeepSeek-V3's ``train_4k``, the slowest
  cell (a task of its own, so that a test can run it beside the others).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.shapes import SHAPES, ShapeSpec, applicable, get_shape
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import step_fn_for
from repro_torch.models.model import FAMILIES
from repro_torch.models.ssm import _dims as ssm_dims
from repro_torch.obs.clock import perf_counter
from repro_torch.parallel import AbstractMesh, param_sharding
from repro_torch.train import AdamWConfig

SMALL_TRAIN = ShapeSpec("small_train", "train", 64, 16)
ROOT = Path(__file__).resolve().parents[1]


class Started:
    """Tasks of this script in a subprocess of their own, started at once
    in ``tmp`` (so that a test module runs its other tests meanwhile) and
    read by :meth:`result`; killed by :meth:`stop` if still running, so no
    fake world outlives the module.  The child keeps the caller's
    environment (its ``HOME`` and ``TMPDIR``), takes the port from this
    checkout and one thread (its work is on ``meta``)."""

    def __init__(self, tmp: Path, *tasks: str, timeout: float):
        self.out, self.log = tmp / "result.json", tmp / "stderr.txt"
        self.deadline = perf_counter() + timeout
        with open(self.log, "w") as log:
            self.proc = subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), str(self.out), *tasks],
                cwd=ROOT, stdout=subprocess.DEVNULL, stderr=log,
                env={**os.environ,  # reprolint: disable=R002 passthrough to a subprocess, no backend choice read
                     "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"})
        self._result = None

    def result(self) -> dict:
        if self._result is None:
            try:
                self.proc.wait(timeout=max(1.0, self.deadline - perf_counter()))
            finally:
                self.stop()
            assert self.proc.returncode == 0, self.log.read_text()[-4000:]
            self._result = json.loads(self.out.read_text())
        return self._result

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def _shapes(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, prefix + (k,)))
        return out
    if isinstance(tree, torch.nn.Module):
        return {n: list(p.shape) for n, p in tree.named_parameters()}
    local = tree.to_local() if hasattr(tree, "to_local") else tree
    return {"/".join(prefix): list(local.shape)}


def partitioned_collectives(cfg, mesh_shape: tuple, names=("data", "model")) -> dict:
    """The collective calls of one partitioned train step (remat on, one
    microbatch, the batch split on the data axes, the FFN and the
    vocabulary split on ``model``), counted by hand from the rules of
    ``parallel/partition.py``'s docstring:

    - each parameter, on a data axis that splits it: an all-gather in each
      forward pass (a layer's two: the forward and the recomputation) and
      a reduce-scatter; on one that replicates it: an all-reduce;
    - on ``model``, attention replicated: every projection that ``model``
      splits gathered in each pass (its gradient sliced back, no call);
      attention by heads: the per-head norms' all-reduce, and where KV
      heads are fewer than ``model``, ``wk`` / ``wv`` (and their biases)
      gathered in each pass and reduce-scattered;
    - per layer, the FFN's input all-reduce (``copy_in``'s backward) and
      its output all-reduce, in the forward only (the recomputation stops
      at the layer's last saved tensor, before it); by heads, attention's
      input all-reduce and its output all-reduce in both passes;
    - once: where the vocabulary splits on ``model``, the embedding's and
      the unembedding's all-reduces and the cross-entropy's three (max,
      sum, the target's logit); the cross-entropy's sum over each data
      axis, and the global norm's over every mesh axis.

    The MoE families (``parallel/experts.py``), the experts split on
    ``model``: the router's gradient all-reduced over ``model``; MLA by
    heads: its low-rank path's four parameters' likewise; per MoE layer
    and data axis, under ``"gspmd"``, the shards' counts all-gathered and
    the tokens' buffer reduce-scattered, the outputs all-gathered and the
    aux loss's probability sums all-reduced, each in both passes, and the
    two buffers' backward (an all-gather, a reduce-scatter).  DeepSeek's
    MTP head: its block one more recomputed layer, ``mtp/proj`` and
    ``mtp/norm`` gathered once, the second embedding lookup, the second
    unembedding and cross-entropy, and its sum over each data axis.

    The Mamba2 layers (``parallel/ssm.py``), where the SSD heads split on
    ``model`` or ``out_proj`` 's row block takes the rank's slice of ``y``:
    every mixer weight but ``out_proj`` summed over ``model`` (``in_proj``
    gathered in each pass and reduce-scattered where ``model`` splits it,
    else all-reduced); per layer, the mixer's input all-reduce and its
    output all-reduce (forward only), and in ``"heads"`` mode the gated
    norm's sums all-reduced in both passes and in the backward.  Where
    neither, a split ``in_proj`` gathered in each pass.  Zamba2's shared
    block: a decoder layer at each of its uses, its gathers and their
    backward once a use."""
    sizes = dict(zip(names, mesh_shape))
    m = sizes["model"]
    data = [a for a in names if a != "model" and sizes[a] > 1]
    heads = cfg.n_heads % m == 0 and (cfg.n_kv_heads % m == 0 or m % cfg.n_kv_heads == 0)
    kv_whole = heads and cfg.n_kv_heads % m != 0 and cfg.block_pattern != "mla_moe"
    rules = param_sharding(AbstractMesh(tuple(mesh_shape), tuple(names)),
                           FAMILIES[cfg.block_pattern](cfg, device="meta"))
    experts_split = bool(cfg.moe.n_experts) and cfg.moe.n_experts % m == 0
    mtp = cfg.block_pattern == "mla_moe" and cfg.mtp_depth > 0
    ssm = cfg.block_pattern in ("mamba2", "zamba2")
    uses = cfg.n_layers // cfg.hybrid_period if cfg.block_pattern == "zamba2" else 0
    blocks = (uses if ssm else cfg.n_layers) + mtp  # attention + FFN blocks run
    if ssm:
        mixer = rules["layers"]["0"]["mamba"]
        ssm_heads = ssm_dims(cfg)[1] % m == 0
        partial = ssm_heads or mixer["out_proj"][0] == "model"
    ag = rs = ar = 0
    stack = [((), rules)]
    while stack:
        path, node = stack.pop()
        if isinstance(node, dict):
            stack.extend((path + (k,), v) for k, v in node.items())
            continue
        axes = {a for entry in node if entry
                for a in ((entry,) if isinstance(entry, str) else entry)}
        times = uses if path[0] == "shared_attn" else 1
        passes = 2 if path[0] in ("layers", "shared_attn") or path[:2] == ("mtp", "block") else 1
        for a in data:
            if a in axes:
                ag, rs = ag + passes * times, rs + times
            else:
                ar += times
        if m > 1 and experts_split and path[-2] == "router":
            ar += 1
        if m > 1 and "mamba" in path:
            if "out_proj" in path:
                continue
            if partial:
                ag, rs, ar = ((ag + passes, rs + 1, ar) if "model" in axes
                              else (ag, rs, ar + 1))
            elif "model" in axes:
                ag += passes
            continue
        if m == 1 or "attn" not in path:
            continue
        if not heads:
            ag += passes * times if "model" in axes else 0
        elif path[-2] in ("q_norm", "k_norm", "wq_a", "q_a_norm", "wkv_a", "kv_a_norm"):
            ar += times
        elif kv_whole and path[-2] in ("wk", "wv"):
            if "model" in axes:
                ag, rs = ag + passes * times, rs + times
            else:
                ar += times
    if m > 1:
        vocab = "model" in (rules["embed"]["table"][0],)  # the vocabulary split on model
        ar += blocks * (2 + (3 if heads else 0)) + (1 + 1 + 3) * (1 + mtp) * vocab
        if ssm and partial:
            ar += cfg.n_layers * (2 + (3 if ssm_heads else 0))
    if cfg.moe.n_experts and cfg.moe.dispatch == "gspmd":
        ag += blocks * 5 * len(data)
        rs += blocks * 3 * len(data)
        ar += blocks * 2 * len(data)
    ar += len(data) * (1 + mtp) + len(names)
    return {"all-gather": ag, "all-reduce": ar, "reduce-scatter": rs}


def partitioned_decode_collectives(cfg, mesh_shape: tuple, names=("data", "model"),
                                   layout: str = "sequence") -> dict:
    """The collective calls of one partitioned decode step (no gradient:
    forward only), counted by hand from ``parallel/partition.py``'s
    docstring: each parameter, on a data axis that splits it, one
    all-gather (Zamba2's shared block's, once a use); on ``model``, per
    attention + FFN block, with the cache's sequence on ``model``
    (``layout="sequence"``) one all-gather of the split projections' rows
    and the softmax combine's two all-reduces (max; the weighted sums),
    with its KV heads on ``model`` (``"heads"``) neither, ``wo`` 's and the
    FFN's all-reduces where ``model`` splits them; per Mamba2 layer, the
    projection's rows all-gathered where ``model`` splits ``in_proj`` and
    ``out_proj`` 's all-reduce where it splits ``out_proj`` and, where the
    SSD heads split, the gated norm's sums all-reduced; once, the
    embedding's all-reduce."""
    sizes = dict(zip(names, mesh_shape))
    m = sizes["model"]
    data = [a for a in names if a != "model" and sizes[a] > 1]
    rules = param_sharding(AbstractMesh(tuple(mesh_shape), tuple(names)),
                           FAMILIES[cfg.block_pattern](cfg, device="meta"))
    uses = cfg.n_layers // cfg.hybrid_period if cfg.block_pattern == "zamba2" else 0
    ag = ar = 0
    split = {}
    stack = [((), rules)]
    while stack:
        path, node = stack.pop()
        if isinstance(node, dict):
            stack.extend((path + (k,), v) for k, v in node.items())
            continue
        axes = {a for entry in node if entry
                for a in ((entry,) if isinstance(entry, str) else entry)}
        if path[0] != "mtp":  # decode never runs the MTP head
            ag += sum(a in axes for a in data) * (uses if path[0] == "shared_attn" else 1)
        split[path] = "model" in axes
    if m > 1:
        # the MoE layers' outputs (the routed experts' and the shared
        # expert's) meet in one all-reduce; MLA gathers its query rows and
        # wkv_b over model
        mla = cfg.block_pattern == "mla_moe"
        if cfg.block_pattern == "mamba2":
            block, n_blocks = None, 0
        else:
            block, n_blocks = ((("shared_attn",), uses) if uses
                               else (("layers", "0"), cfg.n_layers))
        if block is not None:
            rows = ("wq_b",) if mla else ("wq", "wk", "wv")
            qkv = any(split[block + ("attn", n, "w")] for n in rows)
            ffn = (split[block + ("ffn", "experts", "wi_gate")] if cfg.moe.n_experts
                   else split[block + ("ffn", "wo", "w")])
            wo = split[block + ("attn", "wo", "w")]
            if layout == "heads":
                ar += n_blocks * (1 + ffn)
            else:
                ag += n_blocks * (qkv + (mla and split[block + ("attn", "wkv_b", "w")]))
                ar += n_blocks * (2 + wo + ffn)
        if uses or cfg.block_pattern == "mamba2":
            mixer = ("layers", "0", "mamba")
            ag += cfg.n_layers * split[mixer + ("in_proj", "w")]
            ar += cfg.n_layers * (split[mixer + ("out_proj",)] + (ssm_dims(cfg)[1] % m == 0))
        ar += split[("embed", "table")]
    return {k: v for k, v in (("all-gather", ag), ("all-reduce", ar)) if v}


def task_world() -> dict:
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard
    from torch.distributed.tensor.debug import CommDebugMode

    out = {}
    for multi, world in ((False, 256), (True, 512)):
        with dryrun.fake_world(world, rank=world - 1):
            mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
            x = torch.empty(64, 32, device="meta")
            with CommDebugMode() as comm:
                d = DTensor.from_local(x, mesh, [Shard(0)] * (mesh.ndim - 1) + [Shard(1)],
                                       run_check=False)
                full = d.full_tensor()
                y = torch.empty(8, device="meta")
                dist.all_reduce(y, group=mesh.get_group("model"))
            out["multi" if multi else "single"] = {
                "shape": list(mesh.shape), "names": list(mesh.mesh_dim_names),
                "coordinate": mesh.get_coordinate(), "world": dist.get_world_size(),
                "full": list(full.shape), "full_device": str(full.device),
                "comm_total": comm.get_total_counts(),
                "comm": {str(k): v for k, v in comm.get_comm_counts().items()}}
    return out


def task_blocks(multi: bool) -> dict:
    out = {}
    opt = AdamWConfig()
    mesh_name = "pod2x16x16" if multi else "pod16x16"
    with dryrun.fake_world(512 if multi else 256):
        mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
        for arch in ARCHS:
            cfg = get_config(arch)
            row = {}
            for shape in SHAPES:
                if not applicable(cfg, shape)[0]:
                    continue
                if shape.kind == "train":
                    continue  # its batch is the global batch; its state, the params'
                _, args = step_fn_for(cfg, shape, opt, mesh=mesh, in_shardings=(
                    dryrun.shardings_for(mesh, cfg, shape, opt)))
                row.setdefault("params", _shapes(args[0]))
                if shape.kind == "prefill":
                    row[f"batch/{shape.name}"] = _shapes(args[1])
                else:
                    row[f"batch/{shape.name}"] = _shapes({"tokens": args[1]})
                    row[f"cache/{shape.name}"] = _shapes(args[2])
            out[f"{mesh_name}/{arch}"] = row
    return out


def task_cells(out_dir: str) -> dict:
    out = {}
    cfg = get_config("qwen1.5-4b").scaled(n_layers=2)
    for rank in (0, 255):
        c = dryrun.count_cell(cfg, SMALL_TRAIN, multi_pod=False, rank=rank)
        out[f"small_train/{rank}"] = {
            "flops": c.flops, "bytes": c.bytes, "ops": c.collective_ops,
            "operand": c.collective_operand_bytes, "wire": c.collective_wire_bytes,
            "by_link": c.wire_bytes_by_link, "peak": c.peak_bytes}
    lo, hi, _, _ = roofline._probe_depths(get_config("qwen1.5-4b"))
    mid = lo.scaled(n_layers=3)
    shape = get_shape("decode_32k")
    for name, c_ in (("lo", lo), ("mid", mid), ("hi", hi)):
        c = dryrun.count_cell(c_, shape, multi_pod=False)
        out[f"depth/{name}"] = {"layers": c_.n_layers, "flops": c.flops, "bytes": c.bytes,
                                "wire": c.collective_wire_bytes}
    out["cell/qwen1.5-4b/decode_32k"] = dryrun.run_cell("qwen1.5-4b", "decode_32k", False,
                                                        out_dir)
    return out


def task_deepseek(out_dir: str) -> dict:
    return dryrun.run_cell("deepseek-v3-671b", "train_4k", False, out_dir)


def main() -> None:
    path, tasks = Path(sys.argv[1]), sys.argv[2:]
    out_dir = str(path.parent / "dryrun")
    run = {"world": task_world, "blocks-single": lambda: task_blocks(False),
           "blocks-multi": lambda: task_blocks(True),
           "cells": lambda: task_cells(out_dir), "deepseek": lambda: task_deepseek(out_dir)}
    unknown = [t for t in tasks if t not in run]
    if unknown or not tasks:
        raise SystemExit(f"unknown or no tasks: {unknown}")
    path.write_text(json.dumps({t: run[t]() for t in tasks}))


if __name__ == "__main__":
    main()
