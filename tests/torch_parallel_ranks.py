"""One rank of the port's multi-rank checks on the CPU (``gloo``).

Run by ``tests/test_torch_parallel.py`` and
``tests/test_torch_launch_train.py``, one process per rank::

    python tests/torch_parallel_ranks.py TASK RANK WORLD DIR

The ranks rendezvous through a ``FileStore`` in DIR, read their inputs
from DIR (numpy files the test wrote) and write their outputs there
(``torch.save``).  This module imports the port only, never jax.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro_torch.backend import set_backend
from repro_torch.obs import clock
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_smoke_config
from repro_torch.launch import train as launch
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.ffn import MoE
from repro_torch.models.moe_sharded import moe_apply_sharded, moe_route_sharded
from repro_torch.parallel import gather_state, set_mesh, shard, split_batch
from repro_torch.parallel.sharding import local_block
from repro_torch.train import AdamWConfig, make_train_step, train_state_init
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
