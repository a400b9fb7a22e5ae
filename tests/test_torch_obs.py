"""The port's observability (``repro_torch.obs``) against the reference's.

First every test of ``tests/test_obs.py``, on the port: the trace ring
buffer, the Chrome round trip, the metrics registry, the device profiler
and the contract that a run with a session active is schedule-identical
to one without.  Then the parity half: the same inputs run through the
reference's engine / plane under ``repro.obs.observe()`` and through the
port's under ``repro_torch.obs.observe()`` give the same trace records —
every record whose fields are sim time, record for record (wall-clock
fields masked: the admission overhead, tick-phase spans, device
dispatches) — and the same counters (all but ``device.*.compile*``) and
sim-time histograms.  Last the report CLI and ``perf_regressions``.
Everything runs on the CPU: the device adapters take their kernels'
plain versions.
"""

import json

import numpy as np
import pytest
import torch

import repro.obs as ref_obs
import repro.placement as ref_placement
import repro.runtime as ref_runtime
import repro.traces as ref_traces
from repro.obs import trace as ref_trace_mod
from repro_torch import backend, convert, obs
from repro_torch.core import AssignmentProblem, TaskGroup
from repro_torch.obs import Histogram, Metrics, TraceRecorder, parse_chrome_trace
from repro_torch.obs import report
from repro_torch.obs import trace as trace_mod
from repro_torch.obs.metrics import perf_regressions
from repro_torch.obs.session import (
    SPEC_CLONE_WON,
    ObsSession,
    active,
)
from repro_torch.runtime import ControlPlane, SchedulingEngine, make_policy
from repro_torch.traces import generate


@pytest.fixture(autouse=True, scope="module")
def _cpu_one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with backend.set_backend(device="cpu"):
        yield
    torch.set_num_threads(threads)


# ---- ring buffer ------------------------------------------------------------


def test_ring_buffer_overwrites_oldest():
    rec = TraceRecorder(capacity=8)
    for i in range(12):
        rec.record(trace_mod.INST_ARRIVAL, ts=i, a=i)
    assert len(rec) == 8
    assert rec.total == 12
    assert rec.dropped == 4
    assert [r[1] for r in rec.records()] == list(range(4, 12))


def test_ring_buffer_rejects_bad_capacity():
    with pytest.raises(ValueError):
        TraceRecorder(capacity=0)


def test_intern_is_stable():
    rec = TraceRecorder(capacity=4)
    a = rec.intern("wf-groups")
    b = rec.intern("rd-device")
    assert rec.intern("wf-groups") == a != b
    assert rec.strings == ("wf-groups", "rd-device")


def test_to_table_matches_records():
    rec = TraceRecorder(capacity=16)
    rec.record(trace_mod.SPAN_JOB, ts=3, dur=7, a=1, c=5)
    rec.record(trace_mod.INST_STEAL, ts=4, dur=2, a=1, b=0, c=3, link=1)
    table = rec.to_table()
    assert list(table["ts"]) == [3, 4]
    assert list(table["kind"]) == [trace_mod.SPAN_JOB, trace_mod.INST_STEAL]
    assert table["strings"].size == 0


def test_record_kinds_match_reference():
    assert trace_mod.KIND_NAMES == ref_trace_mod.KIND_NAMES
    assert trace_mod.SLOT_US == ref_trace_mod.SLOT_US


# ---- Chrome trace_event export ---------------------------------------------


def _synthetic_recorder(mod=trace_mod, recorder=TraceRecorder):
    """One of every kind, with a steal link and a matched spec pair."""
    rec = recorder(capacity=64)
    rec.record(mod.INST_ARRIVAL, ts=0, a=1, c=4)
    rec.record(mod.INST_ADMIT, ts=0, a=1, c=1200)
    rec.record(mod.INST_FIRST_SERVICE, ts=1, a=1)
    rec.record(mod.INST_STEAL, ts=2, dur=3, a=1, b=0, c=2, link=1)
    rec.record(mod.INST_SPEC_LAUNCH, ts=3, a=1, b=0, c=2, link=2)
    rec.record(mod.INST_SPEC_RESOLVE, ts=5, a=1, b=SPEC_CLONE_WON, c=4, link=2)
    rec.record(mod.INST_REASSIGN, ts=5, a=1, c=1)
    rec.record(mod.SPAN_JOB, ts=0, dur=6, a=1, c=4)
    rec.record(mod.INST_FAILED, ts=6, a=2)
    rec.record(mod.SPAN_SERVE, ts=1, dur=2, a=9, c=40)
    rec.record(mod.INST_PLACEMENT, ts=4, a=rec.intern("evict:blk0"), b=3)
    rec.record(mod.SPAN_TICK, ts=100, dur=50, a=rec.intern("service"))
    rec.record(mod.INST_DEVICE, ts=200, dur=30, a=rec.intern("wf-groups"), b=1, c=30)
    return rec


def test_chrome_trace_round_trips_through_json():
    rec = _synthetic_recorder()
    payload = json.loads(json.dumps(rec.to_chrome_trace()))
    records, strings = parse_chrome_trace(payload)
    assert records == rec.records()
    assert tuple(strings) == rec.strings


def test_chrome_trace_shape_is_valid():
    rec = _synthetic_recorder()
    chrome = rec.to_chrome_trace()
    events = chrome["traceEvents"]
    for ev in events:
        assert ev["ph"] in {"M", "X", "i", "s", "f"}
        assert "pid" in ev and "name" in ev
        if ev["ph"] == "X":
            assert ev["dur"] >= 1 and ev["ts"] >= 0
    job_spans = [e for e in events if e["ph"] == "X" and e.get("cat") == "job"]
    assert len(job_spans) == 1
    assert job_spans[0]["ts"] == 0
    assert job_spans[0]["dur"] == 6 * trace_mod.SLOT_US
    for cat in ("steal", "spec"):
        starts = [e for e in events if e["ph"] == "s" and e["cat"] == cat]
        ends = [e for e in events if e["ph"] == "f" and e["cat"] == cat]
        assert len(starts) == 1 and len(ends) == 1
        assert starts[0]["id"] == ends[0]["id"]
    device = [e for e in events if e.get("cat") == "device"]
    assert device[0]["args"]["cache_miss"] is True
    assert device[0]["args"]["host_fallback"] is False


def test_chrome_export_equals_reference_but_for_the_generator():
    ours = _synthetic_recorder().to_chrome_trace()
    theirs = _synthetic_recorder(ref_trace_mod, ref_obs.TraceRecorder).to_chrome_trace()
    assert ours["otherData"].pop("generator") == "repro_torch.obs"
    theirs["otherData"].pop("generator")
    assert ours == theirs


def test_parse_accepts_bare_event_list():
    rec = _synthetic_recorder()
    events = rec.to_chrome_trace()["traceEvents"]
    records, strings = parse_chrome_trace(events)
    assert records == rec.records()
    assert strings == []


# ---- metrics ----------------------------------------------------------------


def test_histogram_buckets_and_quantiles():
    h = Histogram()
    for v in (0, 1, 1, 3, 100):
        h.observe(v)
    assert h.count == 5
    assert h.max == 100
    assert h.mean == pytest.approx(21.0)
    assert h.quantile(0.0) == 0
    assert h.quantile(0.5) == 1
    assert h.quantile(1.0) >= 100
    s = h.summary()
    assert s["count"] == 5.0 and s["max"] == 100.0


def test_histogram_clamps_negative_values():
    h = Histogram()
    h.observe(-5)
    assert h.count == 1 and h.max == 0 and h.total == 0


def test_metrics_snapshot_table_and_npz(tmp_path):
    m = Metrics()
    m.inc("jobs.arrived")
    m.set_gauge("queue.segments", 3.0)
    m.observe("jobs.jct_slots", 12)
    m.snapshot(5)
    m.inc("jobs.arrived", 2)
    m.set_gauge("queue.segments", 1.0)
    m.snapshot(9)
    table = m.to_table()
    assert list(table["tick"]) == [5, 9]
    assert list(table["gauge.queue.segments"]) == [3.0, 1.0]
    assert list(table["counter.jobs.arrived"]) == [1.0, 3.0]
    assert table["hist.jobs.jct_slots.count"][0] == 1.0
    assert m.n_snapshots == 2
    path = tmp_path / "metrics.npz"
    m.save_npz(str(path))
    loaded = np.load(path)
    assert set(loaded.files) == set(table)
    np.testing.assert_array_equal(loaded["tick"], table["tick"])


def _n_servers(jobs) -> int:
    return 1 + max(max(g.servers) for j in jobs for g in j.groups)


def test_snapshot_cadence_respects_metrics_every():
    jobs = generate("bursty", n_jobs=25, seed=3)
    n = _n_servers(jobs)
    with obs.observe(trace=False, device=False, metrics_every=1) as dense:
        SchedulingEngine(n, make_policy("wf")).run(jobs)
    with obs.observe(trace=False, device=False, metrics_every=8) as sparse:
        SchedulingEngine(n, make_policy("wf")).run(jobs)
    assert dense.metrics.n_snapshots > sparse.metrics.n_snapshots > 0


def test_perf_regressions_flags_tick_phases_and_compiles():
    old, new = Metrics(), Metrics()
    for v in (10, 12):
        old.observe("tick.service.us", v)
        new.observe("tick.service.us", 5 * v)
    old.inc("device.wf-groups.compiles")
    new.inc("device.wf-groups.compiles")
    new.inc("device.rd-device.compiles")
    old.snapshot(0)
    new.snapshot(0)
    regs = {r["name"]: r for r in perf_regressions(old.to_table(), new.to_table())}
    assert set(regs) == {"hist.tick.service.us.mean", "hist.tick.service.us.p99"}
    assert regs["hist.tick.service.us.mean"]["ratio"] == pytest.approx(5.0)
    assert perf_regressions(old.to_table(), new.to_table(), threshold=6.0) == []
    assert perf_regressions(old.to_table(), new.to_table(), min_value=1e9) == []


# ---- device profiler --------------------------------------------------------


def test_device_profiler_splits_compile_and_exec():
    s = ObsSession()
    prof = s.device
    sig = (16, 32, 1)
    for _ in range(3):
        prof.record("wf-groups", sig, prof.start())
    prof.record("rd-device", (8, 4, 2), prof.start(), fallback=True)
    m = s.metrics
    assert m.counter("device.wf-groups.calls") == 3
    assert m.counter("device.wf-groups.compiles") == 1
    assert m.histogram("device.wf-groups.compile_us").count == 1
    assert m.histogram("device.wf-groups.exec_us").count == 2
    assert m.counter("device.rd-device.host_fallback") == 1
    device_events = [r for r in s.trace.records() if r[0] == trace_mod.INST_DEVICE]
    assert len(device_events) == 4
    assert device_events[0][4] & 1
    assert not (device_events[2][4] & 1)
    assert device_events[3][4] & 2


def test_wf_torch_dispatch_is_profiled():
    prob = AssignmentProblem(
        busy=np.zeros(4, dtype=np.int64),
        mu=np.ones(4, dtype=np.int64),
        groups=(TaskGroup(size=3, servers=(0, 1)),),
    )
    from repro_torch.core.wf_torch import water_filling_torch

    baseline = water_filling_torch(prob)  # outside any session: no profiling
    with obs.observe() as s:
        profiled = water_filling_torch(prob)
        water_filling_torch(prob)
    assert profiled.alloc == baseline.alloc and profiled.phi == baseline.phi
    m = s.metrics
    assert m.counter("device.wf-groups.calls") == 2
    assert m.counter("device.wf-groups.compiles") == 1  # one variant
    assert m.histogram("device.wf-groups.exec_us").count == 1
    strings = s.trace.strings
    assert "wf-groups('wf-groups', 4, 1, 'torch')" not in strings  # cpu: the cuda route
    assert "wf-groups('wf-groups', 128, 1, 'cuda')" in strings


def test_rd_torch_dispatch_is_profiled_with_its_kernelcheck_key():
    from repro_torch.core import rd_torch

    prob = AssignmentProblem(
        busy=np.array([3, 0, 1, 0], dtype=np.int64),
        mu=np.ones(4, dtype=np.int64),
        groups=(TaskGroup(6, (0, 1, 2)), TaskGroup(4, (1, 3))),
    )
    want = rd_torch.replica_deletion_torch(prob)
    with obs.observe() as s:
        got = rd_torch.replica_deletion_torch(prob)
        chained = rd_torch.replica_deletion_torch_chain([prob, prob])
    assert got.alloc == want.alloc and chained[0].alloc == want.alloc
    m = s.metrics
    assert m.counter("device.rd-device.calls") == 1
    assert m.counter("device.rd-chain.calls") == 1
    assert m.counter("device.rd-device.host_fallback") == 0
    c = rd_torch.rd_slot_capacity(prob)
    assert f"rd-device('rd-device', 4, {c}, 4)" in s.trace.strings
    assert f"rd-chain('rd-chain', 4, {c}, 4, 2)" in s.trace.strings


def test_serve_decode_is_profiled_per_step():
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = get_smoke_config("qwen1.5-4b")
    params = init_params(torch.Generator().manual_seed(0), cfg)
    with obs.observe() as s:
        eng = ServeEngine(params, cfg, batch_slots=2, max_len=32, eos_token=-1)
        eng.submit(Request(0, np.array([5, 7, 9], np.int32), max_new_tokens=3))
        steps = 0
        while not eng.step():
            steps += 1
    # two prompt tokens fed one at a time, then three decode steps
    assert s.metrics.counter("device.serve-decode.calls") == 2 + steps + 1
    assert s.metrics.counter("device.serve-decode.compiles") == 1


# ---- schedule invariance (the contract) ------------------------------------


def _result_key(res):
    return (
        dict(res.jct),
        res.makespan,
        sorted(res.failed_jobs),
        res.reassignments,
        res.steals,
        res.speculations,
        res.spec_cancels,
        dict(res.serve_latency),
        res.inflight_requests,
    )


@pytest.mark.parametrize(
    "scenario,ordering",
    [("bursty", "fifo"), ("bursty", "setf"), ("alibaba", "fifo")],
)
def test_observed_engine_run_is_schedule_identical(scenario, ordering):
    jobs = generate(scenario, n_jobs=30, seed=7)
    n = _n_servers(jobs)
    plain = SchedulingEngine(n, make_policy("wf", ordering)).run(jobs)
    with obs.observe() as s:
        observed = SchedulingEngine(n, make_policy("wf", ordering)).run(jobs)
    assert _result_key(observed) == _result_key(plain)
    assert s.metrics.counter("jobs.arrived") == len(jobs)
    assert s.metrics.counter("jobs.completed") == len(plain.jct)


def test_observed_online_plane_is_schedule_identical():
    kw = dict(
        scenario="bursty",
        scenario_kw={"n_jobs": 100, "seed": 0},
        stealing=True,
        speculation=True,
    )
    plain = ControlPlane(**kw).drain()
    with obs.observe() as s:
        observed = ControlPlane(**kw).drain()
    assert _result_key(observed) == _result_key(plain)
    assert s.metrics.counter("steal.won") > 0
    assert s.metrics.counter("spec.launched") > 0
    spec_outcomes = (
        s.metrics.counter("spec.won_clone")
        + s.metrics.counter("spec.won_original")
        + s.metrics.counter("spec.aborted")
    )
    assert spec_outcomes == s.metrics.counter("spec.launched")


def test_acceptance_trace_has_lifecycle_span_and_causality_link():
    with obs.observe() as s:
        ControlPlane(
            scenario="bursty",
            scenario_kw={"n_jobs": 100, "seed": 0},
            stealing=True,
            speculation=True,
        ).drain()
    payload = json.loads(json.dumps(s.trace.to_chrome_trace()))
    events = payload["traceEvents"]
    assert [e for e in events if e["ph"] == "X" and e.get("cat") == "job"]
    flow_ids = {(e["cat"], e["id"]) for e in events if e["ph"] == "s"} & {
        (e["cat"], e["id"]) for e in events if e["ph"] == "f"
    }
    assert flow_ids, "no steal/spec causality flow pair in the trace"
    records, strings = parse_chrome_trace(payload)
    assert records == s.trace.records()
    assert tuple(strings) == s.trace.strings


def test_trace_ring_wrap_keeps_run_schedule_identical():
    kw = dict(scenario="bursty", scenario_kw={"n_jobs": 30, "seed": 5})
    plain = ControlPlane(**kw).drain()
    with obs.observe(trace_capacity=32) as s:
        wrapped = ControlPlane(**kw).drain()
    assert _result_key(wrapped) == _result_key(plain)
    assert s.trace.dropped > 0
    assert len(s.trace) == 32


SCENARIO_KW = {
    "bursty": dict(n_jobs=20, total_tasks=2_000, n_servers=30),
    "alibaba": dict(n_jobs=20, total_tasks=2_000, n_servers=30),
    "pareto_diurnal": dict(n_jobs=20, total_tasks=2_000, n_servers=30),
}
# the device RD's plain iteration costs ~1 ms a step on the CPU
TINY = dict(n_jobs=6, total_tasks=200, n_servers=12)


@pytest.mark.parametrize("ordering", ["fifo", "setf", "ocwf-acc"])
@pytest.mark.parametrize("scenario", sorted(SCENARIO_KW))
@pytest.mark.parametrize("assign", ["wf_torch", "obta"])
def test_observed_device_and_exact_runs_are_schedule_identical(assign, scenario, ordering):
    jobs = generate(scenario, seed=2, **SCENARIO_KW[scenario])
    n = SCENARIO_KW[scenario]["n_servers"]
    plain = SchedulingEngine(n, make_policy(assign, ordering)).run(jobs)
    with obs.observe() as s:
        observed = SchedulingEngine(n, make_policy(assign, ordering)).run(jobs)
    assert _result_key(observed) == _result_key(plain)
    if assign == "wf_torch":
        calls = sum(s.metrics.counter(f"device.{k}.calls")
                    for k in ("wf-groups", "wf-chain"))
        assert calls > 0


@pytest.mark.parametrize("ordering", ["fifo", "setf"])
@pytest.mark.parametrize("step_mode", ["slot", "event"])
def test_observed_rd_torch_run_is_schedule_identical(step_mode, ordering):
    jobs = generate("bursty", seed=1, **TINY)
    n = TINY["n_servers"]
    plain = SchedulingEngine(n, make_policy("rd_torch", ordering), step_mode=step_mode).run(jobs)
    with obs.observe() as s:
        observed = SchedulingEngine(
            n, make_policy("rd_torch", ordering), step_mode=step_mode
        ).run(jobs)
    assert _result_key(observed) == _result_key(plain)
    assert (s.metrics.counter("device.rd-device.calls")
            + s.metrics.counter("device.rd-chain.calls")) > 0


@pytest.mark.parametrize("assign", ["wf", "wf_torch"])
def test_observed_stealing_and_speculation_are_schedule_identical(assign):
    jobs = ref_traces.replay_client(ref_traces.generate("bursty", n_jobs=40, seed=5), qps=0.5)
    m = _n_servers(jobs)
    events = tuple(
        ref_runtime.ServerEvent(s, "slowdown", (s // 30) % m, factor=6.0)
        for s in range(10, 400, 30)
    )
    kw = dict(events=convert.from_reference_events(events), stealing=True, speculation=True,
              step_mode="event")
    port_jobs = convert.from_reference_jobs(jobs)
    plain = SchedulingEngine(m, make_policy(assign), **kw).run(port_jobs)
    with obs.observe() as s:
        observed = SchedulingEngine(m, make_policy(assign), **kw).run(port_jobs)
    assert _result_key(observed) == _result_key(plain)
    assert s.metrics.counter("steal.attempted") > 0
    assert s.metrics.counter("spec.launched") > 0


# ---- the trace and counters equal the reference's ---------------------------

_WALL_KINDS = (trace_mod.SPAN_TICK, trace_mod.INST_DEVICE)


def _sim_records(session) -> list[tuple]:
    """The trace's sim-time records, wall-clock fields masked: tick-phase
    spans and device dispatches dropped, the admission overhead zeroed,
    placement strings resolved (intern ids interleave with wall-clock
    strings)."""
    strings = session.trace.strings
    out = []
    for kind, ts, dur, a, b, c, link in session.trace.records():
        if kind in _WALL_KINDS:
            continue
        if kind == trace_mod.INST_ADMIT:
            c = 0
        if kind == trace_mod.INST_PLACEMENT:
            a = strings[a]
        out.append((kind, ts, dur, a, b, c, link))
    return out


def _counters(session) -> dict:
    return {k: v for k, v in session.metrics.counters.items()
            if not (k.startswith("device.") and ".compile" in k)}


def _sim_hists(session) -> dict:
    return {k: h.summary() for k, h in session.metrics.histograms.items()
            if not k.startswith(("tick.", "device.", "sched.overhead"))}


def _sim_table(session) -> dict:
    table = session.metrics.to_table()
    return {k: v.tolist() for k, v in table.items()
            if k == "tick" or k.startswith("gauge.")
            or (k.startswith("counter.") and not k.startswith("counter.device."))}


def _same_observations(ours, theirs):
    assert _sim_records(ours) == _sim_records(theirs)
    assert _counters(ours) == _counters(theirs)
    assert _sim_hists(ours) == _sim_hists(theirs)
    assert _sim_table(ours) == _sim_table(theirs)


def _both_engines(ref_jobs, m, assign="wf", ref_assign=None, ordering="fifo", *,
                  events=(), step_mode="slot", ref_store=None, **kw):
    port_events = convert.from_reference_events(events)
    store = None if ref_store is None else convert.from_reference_store(ref_store)
    with ref_obs.observe() as theirs:
        want = ref_runtime.SchedulingEngine(
            m, ref_runtime.make_policy(ref_assign or assign, ordering), events=events,
            step_mode=step_mode, placement=ref_store, **kw,
        ).run(ref_jobs)
    with obs.observe() as ours:
        got = SchedulingEngine(
            m, make_policy(assign, ordering), events=port_events, step_mode=step_mode,
            placement=store,
            **{k: convert.from_reference_resilience(v) if k == "resilience" else v
               for k, v in kw.items()},
        ).run(convert.from_reference_jobs(ref_jobs))
    assert _result_key(got) == _result_key(want)
    return ours, theirs


@pytest.mark.parametrize("step_mode", ["slot", "event"])
@pytest.mark.parametrize(
    "scenario,ordering",
    [("bursty", "fifo"), ("bursty", "setf"), ("alibaba", "ocwf-acc"),
     ("pareto_diurnal", "fifo")],
)
def test_engine_trace_and_counters_equal_reference(scenario, ordering, step_mode):
    ref_jobs = ref_traces.generate(scenario, seed=4, **SCENARIO_KW[scenario])
    ours, theirs = _both_engines(ref_jobs, SCENARIO_KW[scenario]["n_servers"],
                                 ordering=ordering, step_mode=step_mode)
    _same_observations(ours, theirs)
    assert ours.metrics.counter("jobs.completed") == 20


def test_online_plane_trace_and_counters_equal_reference():
    """Stealing and speculation on: steal / spec-launch / spec-resolve
    records in the reference's order, with the same causality links."""
    kw = dict(scenario="bursty", scenario_kw={"n_jobs": 100, "seed": 0},
              stealing=True, speculation=True)
    with ref_obs.observe() as theirs:
        want = ref_runtime.ControlPlane(**kw).drain()
    with obs.observe() as ours:
        got = ControlPlane(**kw).drain()
    assert _result_key(got) == _result_key(want)
    _same_observations(ours, theirs)
    kinds = {r[0] for r in _sim_records(ours)}
    assert {trace_mod.INST_STEAL, trace_mod.INST_SPEC_LAUNCH,
            trace_mod.INST_SPEC_RESOLVE} <= kinds
    assert ours.metrics.counter("steal.attempted") == theirs.metrics.counter("steal.attempted")


def test_faults_and_retry_trace_equals_reference():
    """A rack failure with retry and a straggler: failed / reassign
    records and the retry counters."""
    ref_jobs = ref_traces.generate("bursty", n_jobs=30, seed=3, total_tasks=3_000, n_servers=40)
    events = ref_traces.rack_failure_timeline(tuple(range(16)), fail_at=20, recover_at=60)
    events += (ref_runtime.ServerEvent(12, "slowdown", 20, factor=4.0),)
    ours, theirs = _both_engines(
        ref_jobs, 40, events=events, step_mode="event", stealing=True,
        resilience=ref_runtime.ResilienceConfig(retry=True),
    )
    _same_observations(ours, theirs)
    m = ours.metrics
    assert m.counter("reassign.events") > 0 and m.counter("jobs.retried") > 0
    assert m.counter("jobs.failed") > 0


def test_placement_churn_trace_equals_reference():
    ref_store = ref_placement.PlacementStore(20)
    ref_jobs = ref_traces.generate("bursty", store=ref_store, n_jobs=24, total_tasks=3_000,
                                   n_servers=20, seed=7, avail_lo=2, avail_hi=4)
    horizon = max(j.arrival for j in ref_jobs) + 300
    events = ref_placement.churn_timeline(ref_store, horizon=horizon, rebalance_every=4,
                                          evict_rate=0.3, seed=3)
    ours, theirs = _both_engines(ref_jobs, 20, events=events, ref_store=ref_store)
    _same_observations(ours, theirs)
    assert ours.metrics.counter("placement.evict") > 0


def test_wf_torch_trace_and_counters_equal_wf_jax():
    """The device adapters: ``device.wf-*.calls`` equal the reference's
    ``wf_jax`` dispatches, one a call (its compile counts differ: the
    variants differ)."""
    ref_jobs = ref_traces.generate("bursty", n_jobs=12, seed=1, total_tasks=1_200,
                                   n_servers=24)
    ours, theirs = _both_engines(ref_jobs, 24, assign="wf_torch", ref_assign="wf_jax")
    _same_observations(ours, theirs)
    calls = [ours.metrics.counter(f"device.{k}.calls") for k in ("wf-groups", "wf-chain")]
    assert sum(calls) > 0


def test_bare_router_serving_trace_equals_reference():
    from repro.serve.engine import ReplicaRouter as RefRouter
    from repro_torch.serve.engine import ReplicaRouter

    def drive(plane):
        for i, (n, at) in enumerate(((40, 0), (25, 1), (60, 3), (10, 8))):
            plane.submit_request(n, at=at)
        return plane.drain()

    with ref_obs.observe() as theirs:
        want = drive(ref_runtime.ControlPlane(3, policy="wf",
                                              router=RefRouter(3, tokens_per_step=10)))
    with obs.observe() as ours:
        got = drive(ControlPlane(3, policy="wf", router=ReplicaRouter(3, tokens_per_step=10)))
    assert got.serve_latency == want.serve_latency
    _same_observations(ours, theirs)
    assert ours.metrics.counter("serve.routed") == 4


# ---- serve + inflight accounting -------------------------------------------


class _SlowPool:
    """Serve-pool stub whose single request finishes on the Nth heartbeat."""

    router = None

    def __init__(self, finish_after: int):
        self.finish_after = finish_after
        self.steps = 0
        self.pending = []

    def submit(self, request, *, model=None, adapter=None, eligible=None):
        self.pending.append(request)
        return 0

    def step(self):
        self.steps += 1
        if self.steps >= self.finish_after and self.pending:
            return [self.pending.pop()]
        return []

    def busy(self):
        return bool(self.pending)


class _Req:
    def __init__(self, rid):
        self.request_id = rid


def test_inflight_requests_surfaced_on_result():
    with obs.observe() as s:
        plane = ControlPlane(4, policy="wf", serve_pool=_SlowPool(3))
        plane.submit_request(8, at=0, request=_Req(7))
        plane.step_until(1)
        assert plane.result().inflight_requests == 1
        res = plane.drain()
    assert res.inflight_requests == 0
    assert res.serve_latency[7] == 4
    assert s.metrics.counter("serve.requests") == 1
    assert s.metrics.counter("serve.completed") == 1
    serve_spans = [r for r in s.trace.records() if r[0] == trace_mod.SPAN_SERVE]
    assert len(serve_spans) == 1
    assert serve_spans[0][2] == 4


# ---- ambient activation -----------------------------------------------------


def test_observe_scopes_nest_and_clear():
    assert active() is None
    with obs.observe(trace=False, device=False) as outer:
        assert active() is outer
        with obs.observe(trace=False, device=False) as inner:
            assert active() is inner
        assert active() is outer
    assert active() is None


def test_sessions_of_the_two_packages_are_independent():
    with ref_obs.observe():
        assert active() is None
    with obs.observe() as s:
        assert ref_obs.active() is None and active() is s


# ---- the report CLI ----------------------------------------------------------


def test_report_writes_artifacts_and_diffs(tmp_path, capsys):
    out = tmp_path / "obs"
    rc = report.main(["--scenario", "bursty", "--out", str(out), "--device", "cpu",
                      "--capacity", "4096"])
    assert rc == 0
    text = capsys.readouterr().out
    assert "device=cpu" in text and "work-stealing" in text
    trace_path = out / "OBS_bursty.trace.json"
    metrics_path = out / "OBS_bursty.metrics.npz"
    records, _ = parse_chrome_trace(json.loads(trace_path.read_text()))
    assert any(r[0] == trace_mod.SPAN_JOB for r in records)
    assert report.main(["--diff", str(metrics_path), str(metrics_path)]) == 0
    # a run whose tick phases all cost nothing against one that costs
    old = tmp_path / "old.npz"
    m = Metrics()
    m.observe("tick.service.us", 0)
    m.snapshot(0)
    m.save_npz(str(old))
    assert report.main(["--diff", str(old), str(metrics_path)]) == 1
