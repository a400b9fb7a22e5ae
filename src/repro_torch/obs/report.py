"""Run a scenario under observability and emit trace + metrics artifacts.

The port's counterpart of ``repro/obs/report.py``::

    PYTHONPATH=src python -m repro_torch.obs.report --scenario bursty --out DIR

runs on the card: the default policy, ``wf_torch``, places every
assignment's water level there (``--policy wf`` is the host algorithm);
``--device cpu`` runs the same on the CPU.  It writes
``DIR/OBS_<scenario>.trace.json`` (Chrome/Perfetto
``trace_event`` JSON — open at https://ui.perfetto.dev) and
``DIR/OBS_<scenario>.metrics.npz`` (per-tick gauge/counter snapshots
plus histogram summaries), and prints a run summary: schedule aggregates, steal /
speculation win-loss accounting, control-plane tick-phase wall times,
and the device-dispatch profile.

Defaults mirror the acceptance scenario: ``bursty`` with stealing and
speculation on, so the emitted trace contains job-lifecycle spans with
steal/spec causality links out of the box.

``--diff OLD.npz NEW.npz`` compares two metrics artifacts instead of
running: control-plane tick-phase host times and device compile counts
are checked column-by-column (:func:`repro_torch.obs.metrics.
perf_regressions`), and the exit status is non-zero when any column
regressed by more than ``--threshold``×.
"""

from __future__ import annotations

import argparse
import json
import os

__all__ = ["main"]


def _fmt_hist(h) -> str:
    s = h.summary()
    return (
        f"n={int(s['count'])} mean={s['mean']:.1f} "
        f"p50={int(s['p50'])} p99={int(s['p99'])} max={int(s['max'])}"
    )


def _section(title: str) -> str:
    return f"\n{title}\n{'-' * len(title)}"


def _diff(args) -> int:
    import numpy as np

    from .metrics import perf_regressions

    old_path, new_path = args.diff
    with np.load(old_path) as old, np.load(new_path) as new:
        regs = perf_regressions(
            old, new, threshold=args.threshold, min_value=args.min_value
        )
    if not regs:
        print(  # reprolint: disable=R008 the port's observability CLI (R008 exempts repro.obs by name)
            f"# no perf regression over {args.threshold}x "
            f"({old_path} -> {new_path})"
        )
        return 0
    print(f"# {len(regs)} perf regression(s) over {args.threshold}x:")  # reprolint: disable=R008 the port's observability CLI (R008 exempts repro.obs by name)
    for r in regs:
        ratio = "inf" if r["ratio"] == float("inf") else f"{r['ratio']:.2f}"
        print(f"  {r['name']}: {r['old']:.1f} -> {r['new']:.1f} ({ratio}x)")  # reprolint: disable=R008 the port's observability CLI (R008 exempts repro.obs by name)
    return 1


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report", description=__doc__
    )
    ap.add_argument("--scenario", default="bursty")
    ap.add_argument("--policy", default="wf_torch")
    ap.add_argument("--ordering", default="fifo")
    ap.add_argument(
        "--no-stealing", dest="stealing", action="store_false", default=True
    )
    ap.add_argument(
        "--no-speculation",
        dest="speculation",
        action="store_false",
        default=True,
    )
    ap.add_argument("--metrics-every", type=int, default=1)
    ap.add_argument("--capacity", type=int, default=1 << 18)
    ap.add_argument("--out", default=os.path.join("results", "torch"))
    ap.add_argument(
        "--diff",
        nargs=2,
        metavar=("OLD", "NEW"),
        help="compare two metrics .npz artifacts instead of running; "
        "exit 1 when a tick-phase time or device compile count regressed "
        "by more than --threshold x",
    )
    ap.add_argument("--threshold", type=float, default=2.0)
    ap.add_argument(
        "--min-value",
        type=float,
        default=0.0,
        help="ignore diff columns whose new value is at or below this "
        "(noise floor for sub-microsecond host times)",
    )
    ap.add_argument(
        "--device",
        default="cuda",
        help="device the run's tensors live on (default cuda; cpu runs "
        "the kernels' plain versions)",
    )
    args = ap.parse_args(argv)

    if args.diff:
        return _diff(args)

    # runtime imports are deferred so `--help` and `--diff` never pay the
    # torch import
    from .. import obs
    from ..backend import set_backend
    from ..runtime.loop import ControlPlane

    with set_backend(device=args.device), obs.observe(
        trace_capacity=args.capacity, metrics_every=args.metrics_every
    ) as session:
        plane = ControlPlane(
            policy=args.policy,
            ordering=args.ordering,
            scenario=args.scenario,
            stealing=args.stealing,
            speculation=args.speculation,
        )
        result = plane.drain()

    os.makedirs(args.out, exist_ok=True)
    trace_path = os.path.join(args.out, f"OBS_{args.scenario}.trace.json")
    with open(trace_path, "w") as f:
        json.dump(session.trace.to_chrome_trace(), f)
    metrics_path = os.path.join(args.out, f"OBS_{args.scenario}.metrics.npz")
    session.metrics.save_npz(metrics_path)

    m = session.metrics
    lines = [
        f"scenario={args.scenario} policy={args.policy} device={args.device} "
        f"ordering={args.ordering} stealing={args.stealing} "
        f"speculation={args.speculation}",
        _section("schedule"),
        f"jobs: {m.counter('jobs.arrived')} arrived, "
        f"{m.counter('jobs.completed')} completed, "
        f"{m.counter('jobs.failed')} failed",
        f"mean JCT: {result.mean_jct:.2f} slots   "
        f"makespan: {result.makespan} slots   "
        f"reassigned tasks: {result.reassignments}",
        f"scheduling overhead: mean {result.mean_overhead_s * 1e6:.0f} us/job",
        f"inflight serve requests at drain: {result.inflight_requests}",
        _section("work-stealing / speculation"),
        f"steal: {m.counter('steal.attempted')} attempted, "
        f"{m.counter('steal.won')} won ({result.steals} tasks moved)",
        f"spec: {m.counter('spec.launched')} launched, "
        f"{m.counter('spec.won_clone')} clone wins, "
        f"{m.counter('spec.won_original')} original wins, "
        f"{m.counter('spec.aborted')} aborted "
        f"({result.spec_cancels} losers cancelled)",
        _section("locality"),
        f"rank-0 replica placements: {m.counter('locality.rank0_tasks')} "
        f"tasks; secondary replicas: {m.counter('locality.secondary_tasks')}",
    ]
    phase_hists = sorted(
        (name, h)
        for name, h in m.histograms.items()
        if name.startswith("tick.")
    )
    if phase_hists:
        lines.append(_section("control-plane tick phases (host us)"))
        lines.extend(
            f"{name.split('.')[1]:>10}: {_fmt_hist(h)}"
            for name, h in phase_hists
        )
    device = sorted(
        (name, count)
        for name, count in m.counters.items()
        if name.startswith("device.")
    )
    if device:
        lines.append(_section("device dispatch"))
        lines.extend(f"{name}: {count}" for name, count in device)
        for name, h in sorted(m.histograms.items()):
            if name.startswith("device."):
                lines.append(f"{name}: {_fmt_hist(h)}")
    lines.append(_section("artifacts"))
    lines.append(f"trace:   {trace_path} ({len(session.trace)} events)")
    lines.append(f"metrics: {metrics_path} ({m.n_snapshots} snapshots)")
    print("\n".join(lines))  # reprolint: disable=R008 the port's observability CLI (R008 exempts repro.obs by name)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
