"""Serving with the paper's scheduler in two places, on the card.

    PYTHONPATH=src python examples_torch/serve_moe_balanced.py [--device cpu]

The port's counterpart of ``examples/serve_moe_balanced.py``, printing
the same lines:

1. **Continuous batching** on a small model: requests stream into a
   shared-cache decode batch (``ServeEngine``; the RMSNorm and
   decode-attention kernels every step).
2. **Replica routing**: request batches spread across 4 model replicas by
   water-filling over queued-token busy times (``ReplicaRouter`` with
   ``wf_torch``: one fused water-filling launch a batch).
3. **MoE expert-replica balancing**: each expert's token load is split
   across its replicas by the fused water-filling kernel
   (``balance_expert_replicas``, one launch for all 32 experts).

The weights are drawn from a ``torch.Generator`` seeded with 0 and the
expert placement from another; :func:`continuous_batching` and
:func:`moe_balancing` take them as arguments instead (the reference's
come from ``jax.random``, whose stream torch cannot reproduce).  The
work runs on ``cuda`` unless ``--device cpu`` asks for the kernels'
plain versions.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import backend
from repro_torch.backend import set_backend
from repro_torch.configs import get_smoke_config
from repro_torch.models import init_params
from repro_torch.serve.engine import ReplicaRouter, Request, ServeEngine
from repro_torch.serve.moe_balance import balance_expert_replicas, replica_placement


def continuous_batching(params=None) -> None:
    cfg = get_smoke_config("qwen1.5-4b")
    if params is None:
        params = init_params(torch.Generator(device=backend.device()).manual_seed(0), cfg)
    engine = ServeEngine(params, cfg, batch_slots=4, max_len=96, eos_token=-1)
    rng = np.random.default_rng(0)
    for rid in range(6):
        prompt = rng.integers(1, cfg.vocab, rng.integers(3, 8)).astype(np.int32)
        engine.submit(Request(rid, prompt, max_new_tokens=8))
    done = []
    for _ in range(64):
        done += engine.step()
        if len(done) == 6:
            break
    print(f"continuous batching: {len(done)} requests finished")
    for r in sorted(done, key=lambda r: r.request_id)[:3]:
        print(f"  req {r.request_id}: {len(r.generated)} new tokens")


def replica_routing() -> None:
    router = ReplicaRouter(n_replicas=4, tokens_per_step=512, policy="wf_torch")
    rng = np.random.default_rng(1)
    for step in range(6):
        n = int(rng.integers(200, 2000))
        placed = router.route(n)
        print(f"  batch of {n:5d} tokens → {placed}")
        router.drain()


def moe_balancing(placement=None) -> None:
    d_devices, n_experts, replicas = 16, 32, 4
    dev = backend.device()
    if placement is None:
        placement = replica_placement(n_experts, d_devices, replicas,
                                      generator=torch.Generator().manual_seed(0))
    placement = torch.tensor(np.asarray(placement), dtype=torch.int64, device=dev)
    rng = np.random.default_rng(2)
    load = torch.as_tensor(rng.zipf(1.4, n_experts) % 512, dtype=torch.int32).to(dev)
    queue = torch.as_tensor(rng.integers(0, 32, d_devices), dtype=torch.int32).to(dev)
    rate = torch.ones(d_devices, dtype=torch.int32, device=dev)
    alloc, phi = balance_expert_replicas(load, placement, queue, rate)
    # everyone → replica 0; experts sharing a first device add up
    naive = queue.clone().index_add_(0, placement[:, 0], load)
    print(
        f"  max device queue: naive={int(naive.max())}  "
        f"water-filled={int((queue + alloc.sum(0)).max())}  (Φ={int(phi)})"
    )


def main(argv=None, *, params=None, placement=None) -> None:
    """The three demos; ``params`` and ``placement`` replace the seeded
    weights and expert placement where given."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)
    with set_backend(device=args.device):
        torch.empty(0, device=args.device)  # without a card: torch's error, before any output
        print("— continuous batching —")
        continuous_batching(params)
        print("— WF replica routing —")
        replica_routing()
        print("— on-device MoE expert-replica balancing —")
        moe_balancing(placement)


if __name__ == "__main__":
    main()
