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

The port trains on one device: ``--production-mesh`` (the reference's
(data, model) pod mesh) waits for the port's ``parallel/``.  The
encoder-decoder arch (whisper-medium) needs frame embeddings that this
driver, like the reference's, does not feed: it ends in
``KeyError: 'frames'``.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

from ..backend import set_backend
from ..checkpoint import CheckpointManager
from ..configs import ARCHS, get_config, get_smoke_config
from ..data import LocalityAwareLoader, ShardStore
from ..train import AdamWConfig, TrainState, make_train_step, train_state_init
from ..train.optim import param_tree, tree_map


def _load(state: TrainState, tree: dict) -> None:
    """Copy a restored ``TrainState.tree()`` into ``state``."""
    with torch.no_grad():
        tree_map(lambda p, r: p.copy_(r), param_tree(state.params), tree["params"])
    state.opt = tree["opt"]


def default_ckpt_dir(arch: str, smoke: bool) -> str:
    """Where a run without ``--ckpt-dir`` keeps its checkpoints."""
    name = f"{arch}-smoke" if smoke else arch
    return os.path.join(tempfile.gettempdir(), "repro_torch_train", name)


def main(argv=None) -> None:
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
                        help="build the (data, model) pod mesh (not ported yet)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)
    if args.production_mesh:
        raise NotImplementedError(
            "--production-mesh needs the port's parallel/ (sharding, constrain, the "
            "expert-parallel MoE), which waits for the parallel/ slice (ROADMAP Queue 1)"
        )

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    opt_cfg = AdamWConfig(total_steps=args.steps)
    with set_backend(device=args.device):
        generator = torch.Generator(device=args.device).manual_seed(0)
        state = train_state_init(generator, cfg, opt_cfg)
        step_fn = make_train_step(cfg, opt_cfg, microbatches=args.microbatches)
        store = ShardStore(
            n_shards=128, n_hosts=8, replicas=3,
            tokens_per_shard=(args.seq_len + 1) * 8, vocab=cfg.vocab,
        )
        loader = LocalityAwareLoader(
            store, batch_tokens=args.batch * (args.seq_len + 1),
            seq_len=args.seq_len + 1, device=args.device,
        )
        mgr = CheckpointManager(args.ckpt_dir or default_ckpt_dir(args.arch, args.smoke), keep=3)
        start, restored = mgr.restore_latest(state.tree())
        if restored is not None:
            _load(state, restored)
            print(f"resumed from step {start}")  # reprolint: disable=R008 the launcher's console output
        step = start or 0

        epoch = 0
        while step < args.steps:
            for tokens in loader.batches(epoch):
                if step >= args.steps:
                    break
                batch = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}
                st, metrics = step_fn(state.as_dict(), batch)
                state = TrainState(st["params"], st["opt"])
                if step % 10 == 0:
                    print(f"step {step:5d} loss={float(metrics['loss']):.4f}")  # reprolint: disable=R008 the launcher's console output
                if step and step % 50 == 0:
                    mgr.save_async(step, state.tree())
                step += 1
            epoch += 1
        mgr.wait()
        mgr.save(step, state.tree())
    print(f"finished at step {step}")  # reprolint: disable=R008 the launcher's console output


if __name__ == "__main__":
    main()
