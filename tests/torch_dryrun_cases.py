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
from repro_torch.obs.clock import perf_counter
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
