#!/usr/bin/env python3
"""Count the slots device RD holds live per job of chip_smoke.py's trace.

Usage::

    python3 tools/rd_slot_census.py [--jobs N] [--seed S]

Runs the port's ``SchedulingEngine`` with the host ``rd`` (fifo) over the
first N jobs of ``chip_smoke.py``'s 4096-server bursty trace and, for
every RD call, counts the most slots that the device RD
(``repro_torch.core.rd_torch``) holds live at once.  A class (group,
surviving servers) holds one slot there, so at each strip that is the
classes live when the strip starts plus the classes it opens.  The host
RD makes the same deletions as the device RD, so the count is exact.

Prints one JSON line per RD call (tasks, groups K, widest group A, the
slot capacity ``rd_slot_capacity`` gives, the peak, the strips), then a
summary line.  CPU only, jax-free; the whole trace (1000 jobs) takes
about six minutes.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (puts src/ on the path)
from repro_torch.core import AssignmentProblem  # noqa: E402
from repro_torch.core import rd  # noqa: E402
from repro_torch.core.rd_torch import rd_slot_capacity  # noqa: E402
from repro_torch.runtime import SchedulingEngine, make_policy  # noqa: E402

CALLS: list[tuple[AssignmentProblem, "_Census"]] = []


class _Census(rd._RDClasses):
    """The host RD's class state, counting live classes as it goes."""

    def __init__(self, problem: AssignmentProblem):
        super().__init__(problem)
        self.live = sum(c.size > 0 for c in self.classes.values())
        self.peak = self.live
        self.opened = 0
        self.strips = 0
        CALLS.append((problem, self))

    def _move(self, c, m: int, k: int) -> None:
        dest = c.dest.get(m)
        if dest is None:
            dest = self.classes.get((c.group, tuple(s for s in c.servers if s != m)))
        opens = dest is None or dest.size == 0
        super()._move(c, m, k)
        self.live += int(opens) - int(c.size == 0)
        self.opened += int(opens)

    def strip(self, m: int) -> int:
        start, self.opened = self.live, 0
        removed = super().strip(m)
        self.strips += 1
        self.peak = max(self.peak, start + self.opened)
        return removed


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--jobs", type=int, default=chip_smoke.N_JOBS)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    jobs = chip_smoke.main_path_trace(args.seed)
    head = sorted(jobs, key=lambda j: (j.arrival, j.job_id))[: args.jobs]
    with mock.patch.object(rd, "_RDClasses", _Census):
        SchedulingEngine(chip_smoke.M_SERVERS, make_policy("rd")).run(head)
    worst_fill = 0.0
    over = 0
    for problem, census in CALLS:
        capacity = rd_slot_capacity(problem)
        worst_fill = max(worst_fill, census.peak / capacity)
        over += census.peak > capacity
        print(json.dumps({
            "tasks": problem.n_tasks,
            "groups": len(problem.groups),
            "widest_group": max(len(g.servers) for g in problem.groups),
            "capacity": capacity,
            "peak_live_slots": census.peak,
            "strips": census.strips,
        }))
    print(json.dumps({
        "rd_calls": len(CALLS),
        "jobs": len(head),
        "max_peak_live_slots": max(c.peak for _, c in CALLS),
        "max_peak_over_capacity": worst_fill,
        "calls_over_capacity": over,
        "largest_job_tasks": max(p.n_tasks for p, _ in CALLS),
        "capacities": sorted({rd_slot_capacity(p) for p, _ in CALLS}),
        "strips": sum(c.strips for _, c in CALLS),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
