#!/usr/bin/env python3
"""Time the control plane's steal and clone scans on chip_smoke.py's
straggler drill, as the port runs them and as the reference runs them.

Usage::

    python3 tools/plane_scan_cost.py [--assign wf_torch|wf] [--seed S]

The drill is ``chip_smoke.py``'s ``faults_online`` straggler drill: the
first 200 jobs of the 4096-server bursty trace, replayed at half the
saturation rate, with 64 random servers 6x slower (a new set every 10
slots) and stealing and speculation on.  The port's ``ControlPlane``
finds a thief's donors through an index of their stealable tails and a
clone's target through the locality sets' intersection with the idle
servers; ``_FullScanPlane`` below carries the reference's scans instead
(``src/repro/runtime/loop.py``: every donor's tail walked for every idle
thief, every idle server tried for every clone).  Both must give the
same schedule; the script prints one JSON line per variant with its
wall seconds and counters, then a summary line, and exits non-zero if
the schedules differ.  The scans are host work: with ``--assign wf``
nothing runs on the card; with ``wf_torch`` (the default) every
assignment does, as in ``chip_smoke.py``.  The reference's scans take
minutes here (about 9 on a CPU core), the port's seconds.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)
import torch  # noqa: E402
from repro_torch.backend import set_backend  # noqa: E402
from repro_torch.runtime import ControlPlane, SchedulingEngine, make_policy  # noqa: E402


class _FullScanPlane(ControlPlane):
    """The plane with the reference's two scans, line for line (less its
    observability hooks)."""

    def _steal_scan(self) -> None:
        cluster = self.engine.cluster
        idle = [
            m
            for m in range(self.n_servers)
            if cluster.alive[m] and not cluster.queues[m]
        ]
        if not idle:
            return
        busy = cluster.busy_times()
        donors = sorted(
            (p for p in range(self.n_servers) if len(cluster.queues[p]) >= 2),
            key=lambda p: (-busy[p], p),
        )
        for m in idle:
            if cluster.queues[m]:  # an earlier steal already landed here
                continue
            if self._steal_for(m, donors):
                busy = cluster.busy_times()
                donors.sort(key=lambda p: (-busy[p], p))

    def _spec_scan(self) -> None:
        cluster = self.engine.cluster
        st = self._res
        cfg = self.resilience
        budget = st.adapted_spec_budget()
        if len(self._pairs) >= budget:
            return
        idle = [
            m
            for m in range(self.n_servers)
            if cluster.alive[m] and not cluster.queues[m]
        ]
        if not idle:
            return
        # job -> servers currently holding one of its head fragments
        serving: dict[int, list[int]] = {}
        for p in range(self.n_servers):
            if cluster.alive[p] and cluster.queues[p]:
                j = cluster.queues[p][0].job_id
                if j >= 0:
                    serving.setdefault(j, []).append(p)
        for m in range(self.n_servers):
            if not idle or len(self._pairs) >= budget:
                return
            if not cluster.alive[m] or not cluster.queues[m]:
                continue
            seg = cluster.queues[m][0]
            j = seg.job_id
            if j < 0 or j in self._spec_jobs:
                continue
            if st.spec_launched.get(j, 0) >= cfg.spec_job_quota:
                continue
            # need a stable rate observation on exactly this head first
            if (
                int(st.head_streak[m]) < cfg.spec_detect_window
                or int(st.head_job[m]) != j
            ):
                continue
            job = cluster.jobs[j]
            gids = list(seg.per_group)
            best = None
            best_mu = 0
            for i in idle:
                # the clone carries the whole fragment, so the target
                # must be in EVERY constituent group's locality set
                if all(i in job.groups[g].servers for g in gids):
                    mu_i = int(cluster.effective_mu(job)[i])
                    if best is None or (-mu_i, i) < (-best_mu, best):
                        best, best_mu = i, mu_i
            if best is None:
                continue
            rate_here = float(st.rate[m])
            peers = [
                p
                for p in serving.get(j, ())
                if p != m and st.head_streak[p] > 0
            ]
            # reference speed: the best observed peer on the same job, or
            # the clone target's nominal rate when no peer was measured
            ref_rate = max(
                max((float(st.rate[p]) for p in peers), default=0.0),
                float(best_mu),
            )
            # straggler test on *completion estimates* from observed
            # rates (ceil granularity matters: a 2-slot head vs a 1-slot
            # clone is already a 2x straggler)
            est_here = -(-seg.total // max(int(rate_here), 1))
            est_ref = -(-seg.total // max(int(ref_rate), 1))
            if est_here < cfg.spec_factor * est_ref or est_here - est_ref < 1:
                continue
            self._launch_spec(m, seg, best)
            st.spec_launched[j] = st.spec_launched.get(j, 0) + 1
            idle.remove(best)


def _drill(seed: int) -> tuple[list, tuple]:
    jobs = cs.main_path_trace(seed)
    head = sorted(jobs, key=lambda j: (j.arrival, j.job_id))[: cs.ONLINE_JOBS]
    replayed = cs.replay_client(head, qps=cs.ONLINE_RHO * cs.saturation_qps(head, cs.M_SERVERS))
    horizon = SchedulingEngine(cs.M_SERVERS, make_policy("wf"),
                               step_mode="event").run(replayed).makespan
    return replayed, cs._straggler_timeline(seed, horizon)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--assign", choices=("wf_torch", "wf"), default="wf_torch")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    device = "cuda" if args.assign == "wf_torch" else "cpu"
    if device == "cuda":
        gpu = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip()
    else:
        gpu = None
    with set_backend(device=device):
        replayed, straggle = _drill(args.seed)
        results = {}
        for variant, cls in (("port", ControlPlane), ("reference_scans", _FullScanPlane)):
            t0 = time.perf_counter()
            plane = cls(cs.M_SERVERS, policy=args.assign, events=straggle,
                        stealing=True, speculation=True)
            plane.submit_many(replayed)
            res = plane.drain()
            if device == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            results[variant] = (res, wall)
            print(json.dumps({
                "variant": variant, "assign": args.assign, "servers": cs.M_SERVERS,
                "jobs": len(replayed), "events": len(straggle), "plane_wall_s": wall,
                "mean_jct": res.mean_jct, "steals": res.steals,
                "speculations": res.speculations, "spec_cancels": res.spec_cancels,
            }), flush=True)
    (port, port_wall), (ref, ref_wall) = results["port"], results["reference_scans"]
    differs = [f for f in cs.ONLINE_FIELDS if getattr(port, f) != getattr(ref, f)]
    print(json.dumps({"gpu": gpu, "port_wall_s": port_wall, "reference_scans_wall_s": ref_wall,
                      "reference_over_port": ref_wall / port_wall,
                      "identical": not differs, "differs": differs}))
    return 1 if differs else 0


if __name__ == "__main__":
    raise SystemExit(main())
