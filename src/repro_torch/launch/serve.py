"""Serving driver: ``python -m repro_torch.launch.serve --arch <id> [--smoke]``.

The port's counterpart of ``repro/launch/serve.py``, with the same
flags plus ``--device`` (``cuda`` by default; ``cpu`` runs the kernels'
plain versions).  Continuous batching over a shared decode cache with
WF replica routing; parameters are random, drawn from a seeded
generator on the device.  The two MoE archs (qwen3-moe-235b-a22b,
deepseek-v3-671b) do not fit one card at full depth: serve them with
``--smoke``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..backend import set_backend
from ..configs import ARCHS, get_config, get_smoke_config
from ..models import init_params
from ..serve.engine import ReplicaRouter, Request, ServeEngine


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--arch", choices=ARCHS, default="qwen1.5-4b")
    parser.add_argument("--smoke", action="store_true")
    parser.add_argument("--requests", type=int, default=8)
    parser.add_argument("--max-new", type=int, default=16)
    parser.add_argument("--slots", type=int, default=4)
    parser.add_argument("--replicas", type=int, default=1)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    with set_backend(device=args.device):
        generator = torch.Generator(device=args.device).manual_seed(0)
        params = init_params(generator, cfg)
        engine = ServeEngine(
            params, cfg, batch_slots=args.slots, max_len=256, eos_token=-1
        )
        router = ReplicaRouter(args.replicas, tokens_per_step=1024)

        rng = np.random.default_rng(0)
        t0 = time.perf_counter()  # reprolint: disable=R008 the launcher reports its own wall time
        for rid in range(args.requests):
            prompt = rng.integers(1, cfg.vocab, int(rng.integers(4, 12))).astype(np.int32)
            placed = router.route(len(prompt) + args.max_new)
            print(f"req {rid}: {len(prompt)} prompt tokens → replica {min(placed)}")  # reprolint: disable=R008 the launcher's console output
            engine.submit(Request(rid, prompt, max_new_tokens=args.max_new))

        done = []
        steps = 0
        while len(done) < args.requests and steps < 10_000:
            done += engine.step()
            router.drain()
            steps += 1
        dt = time.perf_counter() - t0  # reprolint: disable=R008 the launcher reports its own wall time
    total_new = sum(len(r.generated) for r in done)
    print(  # reprolint: disable=R008 the launcher's console output
        f"served {len(done)} requests / {total_new} tokens in {dt:.1f}s "
        f"({steps} engine steps, {args.device})"
    )


if __name__ == "__main__":
    main()
