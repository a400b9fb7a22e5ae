"""End-to-end training driver on the card: ~100M-param model, locality-aware data.

    PYTHONPATH=src python examples_torch/train_locality.py [--steps 300]
        [--arch mamba2-130m] [--compress] [--fail-host 3] [--device cpu]

The port's counterpart of ``examples/train_locality.py``, with its flags
and its printed lines:

- data shards replicated over hosts; every epoch's reads placed by
  ``wf_torch`` (``LocalityAwareLoader``: one fused water-filling launch
  an epoch);
- a real model from the zoo (default: mamba2-130m at the reference
  example's reduced width — d_model 256, 4 layers, vocab 8192, float32,
  SSM state 32, chunk 64) trained with AdamW + remat (the RMSNorm and
  SSD-scan kernels, float32 on the CUDA cores);
- checkpoint/restart: an async save every 50 steps, a final save, and
  the latest checkpoint restored on start;
- optional host failure mid-run — reads reroute to surviving replicas
  and training continues without data-order drift;
- optional int8 gradient compression with error feedback on a toy
  regression, in a world of one rank (``gloo`` on the CPU, ``nccl`` on
  the card; an initialised process group is used as it is).

Without ``--ckpt-dir`` the checkpoints go to a folder of the port's own
under the temporary directory, so a run never resumes the reference
example's.  The weights are drawn from a ``torch.Generator`` seeded with
0 unless :func:`train` is given them.  The work runs on ``cuda`` unless
``--device cpu`` asks for the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import backend
from repro_torch.backend import set_backend
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core.wf_torch import water_filling_torch
from repro_torch.data import LocalityAwareLoader, ShardStore
from repro_torch.launch.mesh import make_mesh
from repro_torch.train import AdamWConfig, TrainState, make_train_step, train_state_init
from repro_torch.train.compress import init_error_state, make_compressed_grad_fn
from repro_torch.train.optim import adamw_init, param_tree, tree_map


def default_ckpt_dir(arch: str) -> str:
    """Where a run without ``--ckpt-dir`` keeps its checkpoints."""
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt", arch)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--arch", default="mamba2-130m")
    parser.add_argument("--seq-len", type=int, default=128)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--fail-host", type=int, default=None)
    parser.add_argument("--ckpt-dir", default=None,
                        help="checkpoint folder (default: repro_torch_ckpt/<arch> under "
                        "the temporary directory)")
    parser.add_argument("--compress", action="store_true")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return parser.parse_args(argv)


def model_config(arch: str):
    """``arch`` at the reference example's reduced width."""
    cfg = get_config(arch).scaled(d_model=256, n_layers=4, vocab=8192, dtype="float32")
    if cfg.ssm is not None:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, state_dim=32, chunk=64))
    return cfg


def train(args: argparse.Namespace, params=None) -> None:
    """The training loop of ``args`` on :func:`repro_torch.backend.device`,
    from ``params`` where given (a model of :func:`model_config`)."""
    cfg = model_config(args.arch)
    opt_cfg = AdamWConfig(
        lr=3e-4, warmup_steps=20, total_steps=args.steps, moment_dtype="float32"
    )
    dev = backend.device()
    ckpt_dir = args.ckpt_dir or default_ckpt_dir(args.arch)

    store = ShardStore(
        n_shards=256, n_hosts=16, replicas=3,
        tokens_per_shard=args.seq_len * 8, vocab=cfg.vocab,
    )
    loader = LocalityAwareLoader(
        store, batch_tokens=args.batch * args.seq_len, seq_len=args.seq_len + 1,
        assign=water_filling_torch, device=dev,
    )

    if params is None:
        state = train_state_init(torch.Generator(device=dev).manual_seed(0), cfg, opt_cfg)
    else:
        state = TrainState(params, adamw_init(opt_cfg, params))
    mgr = CheckpointManager(ckpt_dir, keep=2)
    start, restored = mgr.restore_latest(state.tree())
    if restored is not None:
        with torch.no_grad():
            tree_map(lambda p, r: p.copy_(r), param_tree(state.params), restored["params"])
        state.opt = restored["opt"]
        print(f"resumed from step {start}")

    def tree(st: dict) -> dict:
        return TrainState(st["params"], st["opt"]).tree()

    step_fn = make_train_step(cfg, opt_cfg)
    st = state.as_dict()
    step = start or 0
    epoch = 0
    while step < args.steps:
        for tokens in loader.batches(epoch):
            if step >= args.steps:
                break
            if args.fail_host is not None and step == args.steps // 2:
                print(f"!! failing data host {args.fail_host}")
                store.fail_host(args.fail_host)
            batch = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}
            st, metrics = step_fn(st, batch)
            if step % 25 == 0:
                print(
                    f"step {step:4d}  loss={float(metrics['loss']):.4f}  "
                    f"gnorm={float(metrics['grad_norm']):.3f}  "
                    f"lr={float(metrics['lr']):.2e}"
                )
            if step and step % 50 == 0:
                mgr.save_async(step, tree(st))
            step += 1
        epoch += 1
    mgr.wait()
    mgr.save(step, tree(st))
    print(f"done at step {step}; checkpoints in {ckpt_dir}")


@contextlib.contextmanager
def one_rank_world(device_type: str):
    """The initialised process group, or one of one rank (``nccl`` on the
    card, ``gloo`` on the CPU; rendezvous through a ``FileStore`` in a
    temporary directory) destroyed however the block ends."""
    if dist.is_initialized():
        yield
        return
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()


def compression_demo() -> None:
    """int8 EF gradient reduction on a toy problem (a world of one rank)."""
    dev = backend.device()
    xs = np.random.default_rng(0).normal(size=(64, 8)).astype(np.float32)
    ys = xs @ np.arange(8, dtype=np.float32)
    batch = (torch.from_numpy(xs).to(dev), torch.from_numpy(ys).to(dev))

    def grad_fn(params, batch):
        x, y = batch
        p = params.detach().requires_grad_(True)
        return torch.autograd.grad(((x @ p - y) ** 2).mean(), p)[0]

    with one_rank_world(dev.type):
        fn = make_compressed_grad_fn(grad_fn, make_mesh((1,), ("data",), dev.type))
        w = torch.zeros(8, device=dev)
        err = init_error_state(w)
        for _ in range(200):
            g, err = fn(w, batch, err)
            w = w - 0.01 * g
    print("compressed-grad solution ≈", np.round(w.cpu().numpy(), 2))


def main(argv=None, *, params=None) -> None:
    """The example; ``params`` replace the seeded weights where given."""
    args = parse_args(argv)
    with set_backend(device=args.device):
        torch.empty(0, device=args.device)  # without a card: torch's error, before any output
        train(args, params)
        if args.compress:
            compression_demo()


if __name__ == "__main__":
    main()
