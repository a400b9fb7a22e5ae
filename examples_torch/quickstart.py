"""Quickstart on the card: the paper's schedulers in 60 seconds.

    PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]

The port's counterpart of ``examples/quickstart.py``, printing the same
lines.  Builds a small arrival instance and runs every task-assignment
algorithm on it — NLIP and OBTA (host max-flow), WF through ``wf_torch``
(one launch of the fused water-filling kernel), RD through ``rd_torch``
(one launch of the RD step kernel an iteration) and RD+ (``rd_torch``,
then the host 1-opt polish) — then replays a 40-job trace through the
cluster simulator with FIFO vs reordered queues, both assigning with
``wf_torch``.  The work runs on ``cuda`` unless ``--device cpu`` asks for
the kernels' plain versions.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.backend import set_backend
from repro_torch.core import AssignmentProblem, TaskGroup, nlip, obta
from repro_torch.core.rd_plus import replica_deletion_plus
from repro_torch.core.rd_torch import replica_deletion_torch
from repro_torch.core.wf_torch import water_filling_torch
from repro_torch.runtime import ClusterSimulator
from repro_torch.traces import TraceConfig, generate_trace


def single_job() -> None:
    # 3 task groups over 8 servers with overlapping replica sets
    problem = AssignmentProblem(
        busy=np.array([0, 2, 1, 0, 5, 0, 3, 1]),
        mu=np.array([4, 4, 3, 5, 4, 3, 4, 5]),
        groups=(
            TaskGroup(40, (0, 1, 2)),
            TaskGroup(25, (1, 2, 3, 4)),
            TaskGroup(60, (4, 5, 6, 7)),
        ),
    )
    print("single-job assignment (Φ = estimated completion slots):")
    for name, algo in [
        ("NLIP ", nlip),
        ("OBTA ", obta),
        ("WF   ", water_filling_torch),
        ("RD   ", replica_deletion_torch),
        ("RD+  ", replica_deletion_plus),
    ]:
        a = algo(problem)
        print(f"  {name} Φ={a.phi:3d}  realized={a.realized_phi(problem):3d}")


def trace_replay() -> None:
    cfg = TraceConfig(
        n_jobs=40, total_tasks=15_000, n_servers=50, utilization=0.6, seed=7
    )
    jobs = generate_trace(cfg)
    print(f"\ntrace: {len(jobs)} jobs / {sum(j.n_tasks for j in jobs)} tasks")
    fifo = ClusterSimulator(cfg.n_servers, water_filling_torch).run(jobs)
    reord = ClusterSimulator(cfg.n_servers, water_filling_torch, reorder=True).run(jobs)
    print(f"  FIFO + WF       mean JCT = {fifo.mean_jct:6.2f} slots")
    print(f"  OCWF-ACC        mean JCT = {reord.mean_jct:6.2f} slots")
    print(f"  reordering gain = {fifo.mean_jct / reord.mean_jct:.2f}x")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)
    with set_backend(device=args.device):
        torch.empty(0, device=args.device)  # without a card: torch's error, before any output
        single_job()
        trace_replay()


if __name__ == "__main__":
    main()
