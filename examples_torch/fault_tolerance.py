"""Fault tolerance at the scheduling layer, on the card.

    PYTHONPATH=src python examples_torch/fault_tolerance.py [--device cpu]

The port's counterpart of ``examples/fault_tolerance.py``, printing the
same lines.  Replays one trace three times under the reordered scheduler
(OCWF-ACC) assigning with ``wf_torch``: healthy, with two mid-run server
failures, and with two stragglers (4× slowdown) — showing
locality-aware reassignment and busy-time-balanced mitigation.  The work
runs on ``cuda`` unless ``--device cpu`` asks for the kernels' plain
versions.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.backend import set_backend
from repro_torch.core.wf_torch import water_filling_torch
from repro_torch.runtime import ClusterSimulator, ServerEvent
from repro_torch.traces import TraceConfig, generate_trace


def replay() -> None:
    cfg = TraceConfig(
        n_jobs=60, total_tasks=20_000, n_servers=40, utilization=0.6, seed=11
    )
    jobs = generate_trace(cfg)
    print(f"trace: {len(jobs)} jobs / {sum(j.n_tasks for j in jobs)} tasks\n")

    def run(events=()):
        return ClusterSimulator(
            cfg.n_servers, water_filling_torch, reorder=True, events=events
        ).run(jobs)

    healthy = run()
    print(f"healthy:    mean JCT {healthy.mean_jct:6.2f}  makespan {healthy.makespan}")

    failed = run((
        ServerEvent(slot=20, kind="fail", server=3),
        ServerEvent(slot=25, kind="fail", server=17),
    ))
    print(
        f"2 failures: mean JCT {failed.mean_jct:6.2f}  makespan {failed.makespan}  "
        f"tasks reassigned {failed.reassignments}  jobs lost {len(failed.failed_jobs)}"
    )

    straggler = run((
        ServerEvent(slot=15, kind="slowdown", server=5, factor=4.0),
        ServerEvent(slot=15, kind="slowdown", server=6, factor=4.0),
    ))
    print(
        f"stragglers: mean JCT {straggler.mean_jct:6.2f}  makespan {straggler.makespan}  "
        f"(reordering rebalances around the slow servers)"
    )


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)
    with set_backend(device=args.device):
        torch.empty(0, device=args.device)  # without a card: torch's error, before any output
        replay()


if __name__ == "__main__":
    main()
