"""Train driver: ``python -m repro_torch.launch.train --arch <id> [--smoke]``.

The port's counterpart of ``repro/launch/train.py``, with the same
flags plus ``--device`` (``cuda`` by default; ``cpu`` runs the kernels'
plain versions).  It wires together config → train state (random
parameters drawn from a generator seeded with 0 on the device, zero
AdamW moments) → locality-aware data pipeline (shard reads placed by
the host ``water_filling``, the reference's default) → train step →
checkpoint manager with auto-resume: the latest checkpoint in
``--ckpt-dir`` is restored on start, an async save is taken every 50
steps and a final save at the end.  Without ``--ckpt-dir`` the
checkpoints go under the run's temporary directory
(``tempfile.gettempdir()``), one folder per arch and config, so runs of
two archs never resume from each other's state.  A resumed run restarts the loader
at epoch 0, as the reference's loop does.

``--production-mesh`` trains sharded on the (data=16, model=16) mesh
(:func:`repro_torch.launch.mesh.make_production_mesh`): every one of the
256 ranks runs this driver (under a launcher such as ``torchrun``, whose
rendezvous ``torch.distributed.init_process_group`` reads; a world of
another size is refused), on the local CUDA device ``rank %
device_count``.  Each rank builds the same seeded state and keeps its
blocks of it (:func:`repro_torch.train.shard_train_state`), draws the
same seeded loader stream and takes its data shard of each batch inside
the sharded step, under the ambient mesh; only rank 0 prints, and the
checkpoints hold the full tensors (rank 0 writes them), so a restart may
resume onto another mesh.  :func:`train` is that loop for any mesh (the
tests drive it on small ``gloo`` meshes).  The encoder-decoder arch
(whisper-medium) needs frame embeddings that this driver, like the
reference's, does not feed: it ends in ``KeyError: 'frames'``.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import tempfile

import torch
import torch.distributed as dist

from ..backend import set_backend
from ..checkpoint import CheckpointManager
from ..configs import ARCHS, get_config, get_smoke_config
from ..data import LocalityAwareLoader, ShardStore
from ..parallel import set_mesh
from ..train import AdamWConfig, TrainState, make_train_step, train_state_init
from ..train.optim import param_tree, tree_map
from ..train.step import shard_train_state, state_sharding
from .mesh import make_production_mesh


def _load(state: TrainState, tree: dict) -> None:
    """Copy a restored ``TrainState.tree()`` into ``state``."""
    with torch.no_grad():
        tree_map(lambda p, r: p.copy_(r), param_tree(state.params), tree["params"])
    state.opt = tree["opt"]


def default_ckpt_dir(arch: str, smoke: bool) -> str:
    """Where a run without ``--ckpt-dir`` keeps its checkpoints."""
    name = f"{arch}-smoke" if smoke else arch
    return os.path.join(tempfile.gettempdir(), "repro_torch_train", name)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--arch", choices=ARCHS, default="qwen1.5-4b")
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--seq-len", type=int, default=128)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--microbatches", type=int, default=1)
    parser.add_argument("--ckpt-dir", default=None,
                        help="checkpoint folder (default: repro_torch_train/<arch>[-smoke] "
                        "under the temporary directory)")
    parser.add_argument("--smoke", action="store_true",
                        help="reduced config (CPU validation)")
    parser.add_argument("--production-mesh", action="store_true",
                        help="train sharded on the (data=16, model=16) mesh: 256 ranks, "
                        "one device each, started by a launcher such as torchrun")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return parser.parse_args(argv)


def _say(text: str) -> None:
    """The launcher's console output: rank 0's only under a process group."""
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(text, flush=True)  # reprolint: disable=R008 the launcher's console output


def train(args: argparse.Namespace, mesh=None) -> list[float]:
    """The training loop of ``args`` (as :func:`parse_args` gives them),
    sharded on ``mesh`` where given (every rank of its process group calls
    this), on one device otherwise; returns the loss of every step this
    run took."""
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    opt_cfg = AdamWConfig(total_steps=args.steps)
    device = args.device
    if device == "cuda" and mesh is not None:
        device = f"cuda:{torch.cuda.current_device()}"
    with set_backend(device=args.device):
        generator = torch.Generator(device=device).manual_seed(0)
        state = train_state_init(generator, cfg, opt_cfg)
        step_fn = make_train_step(cfg, opt_cfg, microbatches=args.microbatches, mesh=mesh)
        store = ShardStore(
            n_shards=128, n_hosts=8, replicas=3,
            tokens_per_shard=(args.seq_len + 1) * 8, vocab=cfg.vocab,
        )
        loader = LocalityAwareLoader(
            store, batch_tokens=args.batch * (args.seq_len + 1),
            seq_len=args.seq_len + 1, device=device,
        )
        mgr = CheckpointManager(args.ckpt_dir or default_ckpt_dir(args.arch, args.smoke), keep=3)
        if mesh is None:
            start, restored = mgr.restore_latest(state.tree())
            if restored is not None:
                _load(state, restored)
            st = state.as_dict()
            tree_of = lambda st: TrainState(st["params"], st["opt"]).tree()  # noqa: E731
        else:
            st = shard_train_state(mesh, state)
            del state
            start, restored = mgr.restore_latest(st, shardings=(mesh, state_sharding(mesh, st)))
            if restored is not None:
                st = restored
            tree_of = lambda st: st  # noqa: E731
        if restored is not None:
            _say(f"resumed from step {start}")
        step = start or 0

        losses = []
        epoch = 0
        with set_mesh(mesh) if mesh is not None else contextlib.nullcontext():
            while step < args.steps:
                for tokens in loader.batches(epoch):
                    if step >= args.steps:
                        break
                    batch = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}
                    st, metrics = step_fn(st, batch)
                    losses.append(metrics["loss"])
                    if step % 10 == 0:
                        _say(f"step {step:5d} loss={float(metrics['loss']):.4f}")
                    if step and step % 50 == 0:
                        mgr.save_async(step, tree_of(st))
                    step += 1
                epoch += 1
        mgr.wait()
        mgr.save(step, tree_of(st))
    _say(f"finished at step {step}")
    return [float(x) for x in losses]


def main(argv=None) -> None:
    args = parse_args(argv)
    if not args.production_mesh:
        train(args)
        return
    if not dist.is_initialized():
        try:  # the launcher's rendezvous (torchrun's, say)
            dist.init_process_group("nccl" if args.device == "cuda" else "gloo")
        except ValueError as e:
            raise RuntimeError("--production-mesh runs on 256 ranks (world size 256) started "
                               f"by a launcher; no rendezvous was given: {e}") from e
    if args.device == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    train(args, make_production_mesh(device_type=args.device))


if __name__ == "__main__":
    main()
