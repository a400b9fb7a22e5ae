"""The port's online mechanisms — work-stealing, speculation, admission
control and retry-with-backoff — against the reference's, on the
reference suite's setups (rack failures, the rotating straggler, the
staggered flood, overload past saturation).

Both packages get the same jobs, timeline and ``ResilienceConfig``
(through ``convert``); every counter of the result (reassignments,
steals, speculations, cancels, retries, shed set, deferred and heap
peaks) and every JCT must be identical, and no shadow id of a
speculative pair may outlive the run.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.runtime as ref_runtime
import repro.traces as ref_traces
from repro.core import Job as RefJob
from repro.core import TaskGroup as RefTaskGroup
from repro_torch import backend, convert
from repro_torch.runtime import (
    ControlPlane,
    RackEvent,
    ResilienceConfig,
    ResilienceState,
    SchedulingEngine,
    make_policy,
)
from repro_torch.traces import overload_client, rack_failure_timeline

RESULT_FIELDS = ("jct", "makespan", "failed_jobs", "reassignments", "steals",
                 "speculations", "spec_cancels", "shed_jobs", "deferred_peak",
                 "retries", "heap_peak")
REF_ASSIGN = {"wf": "wf", "wf_torch": "wf", "obta": "obta"}


@pytest.fixture(autouse=True, scope="module")
def _cpu_one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with backend.set_backend(device="cpu"):
        yield
    torch.set_num_threads(threads)


def _check_invariant(cluster, slot):
    cluster.assert_invariant()


def _n_servers(jobs):
    return max(s for j in jobs for g in j.groups for s in g.servers) + 1


def _both(ref_jobs, m, *, assign="wf", events=(), resilience=None, **kw):
    """The reference's event-mode run and the port's (invariant-checked
    every tick, ``debug=True``) on the same inputs; every result field
    identical.  Returns the port's result and engine."""
    want = ref_runtime.SchedulingEngine(
        m, ref_runtime.make_policy(REF_ASSIGN[assign]), events=events,
        step_mode="event", resilience=resilience, **kw,
    ).run(ref_jobs)
    engine = SchedulingEngine(
        m, make_policy(assign), events=convert.from_reference_events(events),
        step_mode="event",
        resilience=None if resilience is None else convert.from_reference_resilience(resilience),
        debug=True, on_slot=_check_invariant, **kw,
    )
    got = engine.run(convert.from_reference_jobs(ref_jobs))
    for field in RESULT_FIELDS:
        assert getattr(got, field) == getattr(want, field), field
    assert all(jid >= 0 for jid in engine.cluster.jobs), "a shadow id leaked"
    assert not any(engine.cluster.queues)
    return got, engine


RACK = (0, 1, 2, 3)


def _rack_trace():
    """Three jobs whose every replica lives on the rack, two outside."""
    mu = np.full(6, 2, np.int64)
    jobs = [RefJob(job_id=j, arrival=j, groups=(RefTaskGroup(60, RACK),), mu=mu)
            for j in range(3)]
    jobs += [RefJob(job_id=3 + j, arrival=j, groups=(RefTaskGroup(10, (4, 5)),), mu=mu)
             for j in range(2)]
    return jobs


def _straggler_setup(seed=5):
    """The reference's rotating straggler: a 6x slowdown moves server
    every 30 slots, each lifted 20 slots later, on a re-timed trace."""
    jobs = ref_traces.replay_client(ref_traces.generate("bursty", n_jobs=40, seed=seed),
                                    qps=0.5)
    m = _n_servers(jobs)
    events = tuple(
        ref_runtime.ServerEvent(s, "slowdown", (s // 30) % m, factor=6.0)
        for s in range(10, 400, 30)
    ) + tuple(
        ref_runtime.ServerEvent(s + 20, "speedup", (s // 30) % m)
        for s in range(10, 400, 30)
    )
    return jobs, m, events


def _straggler_trace():
    jobs = ref_traces.generate("bursty", n_jobs=40, seed=5)
    m = _n_servers(jobs)
    events = tuple(ref_runtime.ServerEvent(s, "slowdown", (s // 20) % m, factor=6.0)
                   for s in range(5, 300, 20))
    return jobs, m, events


# ---- retry-with-backoff under correlated faults ------------------------------------


@pytest.mark.parametrize("retry,recover_at,failed", [
    (False, 30, [0, 1, 2]), (True, 30, []), (True, None, [0, 1, 2]),
], ids=["no-retry", "retry-recovers", "retry-exhausted"])
def test_rack_failure_and_retry_match_reference(retry, recover_at, failed):
    events = ref_traces.rack_failure_timeline(RACK, fail_at=4, recover_at=recover_at)
    cfg = ref_runtime.ResilienceConfig(retry=retry)
    got, _ = _both(_rack_trace(), 6, events=events, resilience=cfg)
    assert sorted(got.failed_jobs) == failed
    if retry:
        assert got.retries > 0
    if recover_at is None:  # each rack job burned the whole retry budget
        assert got.retries == len(failed) * ResilienceConfig().retry_limit


def test_passive_config_keeps_slot_event_equivalence():
    ref_jobs = ref_traces.generate("bursty", n_jobs=25, seed=11)
    m = _n_servers(ref_jobs)
    events = ref_traces.rack_failure_timeline((0, 1), fail_at=12, recover_at=40)
    got, _ = _both(ref_jobs, m, assign="wf_torch", events=events,
                   resilience=ref_runtime.ResilienceConfig())
    slot = SchedulingEngine(m, make_policy("wf_torch"),
                            events=convert.from_reference_events(events),
                            resilience=ResilienceConfig()).run(
        convert.from_reference_jobs(ref_jobs))
    assert (slot.jct, slot.makespan, slot.failed_jobs, slot.reassignments) == (
        got.jct, got.makespan, got.failed_jobs, got.reassignments)


def test_admission_and_retry_require_event_mode():
    for cfg in (ResilienceConfig(admission=True), ResilienceConfig(retry=True)):
        with pytest.raises(ValueError, match="event"):
            SchedulingEngine(4, resilience=cfg)


def test_rack_event_validation():
    with pytest.raises(ValueError, match="non-empty"):
        RackEvent(0, "fail", ())
    with pytest.raises(ValueError, match="kind"):
        RackEvent(0, "melt", (0,))
    assert RackEvent(0, "fail", (3, 1, 1)).servers == (1, 3)
    with pytest.raises(ValueError, match="after"):
        rack_failure_timeline((0, 1), fail_at=5, recover_at=5)


# ---- admission control ---------------------------------------------------------------


def test_admission_defers_then_sheds_like_the_reference():
    mu = np.asarray([1], np.int64)
    flood = [RefJob(job_id=j, arrival=j, groups=(RefTaskGroup(10, (0,)),), mu=mu)
             for j in range(20)]
    cfg = ref_runtime.ResilienceConfig(admission=True, lag_defer_budget=15,
                                       lag_shed_budget=30, defer_queue_cap=4)
    got, _ = _both(flood, 1, resilience=cfg)
    assert got.n_shed > 0 and got.deferred_peak > 0
    assert len(got.jct) + got.n_shed == len(flood)
    assert all(got.shed_jobs[j] == flood[j].arrival for j in got.shed_jobs)


@pytest.mark.parametrize("assign", ["wf", "wf_torch"])
def test_overload_past_saturation_bounds_the_heap_like_the_reference(assign):
    base = ref_traces.generate("bursty", n_jobs=40, seed=1)
    m = _n_servers(base)
    jobs = ref_traces.overload_client(base, rho=1.5, n_servers=m)
    port = overload_client(convert.from_reference_jobs(base), rho=1.5, n_servers=m)
    assert [(j.job_id, j.arrival) for j in port] == [(j.job_id, j.arrival) for j in jobs]
    cfg = ref_runtime.ResilienceConfig(admission=True, lag_defer_budget=4,
                                       lag_shed_budget=12, defer_queue_cap=8)
    got, _ = _both(jobs, m, assign=assign, resilience=cfg)
    assert got.n_shed > 0
    assert got.heap_peak <= len(jobs) + 16


# ---- stealing and speculation -----------------------------------------------------


@pytest.mark.parametrize("stealing,speculation", [
    (True, False), (False, True), (True, True),
], ids=["steal", "spec", "steal+spec"])
def test_online_mechanisms_match_reference_on_rotating_straggler(stealing, speculation):
    jobs, m, events = _straggler_setup(seed=8 if stealing and speculation else 5)
    got, _ = _both(jobs, m, events=events, stealing=stealing, speculation=speculation)
    assert set(got.jct) == {j.job_id for j in jobs}
    if stealing:
        assert got.steals > 0
    if speculation:
        assert got.speculations > 0 and got.spec_cancels > 0


@pytest.mark.parametrize("m,stragglers", [(256, 4), (320, 5)])
def test_steal_and_clone_scans_match_reference_at_hundreds_of_servers(m, stragglers):
    """The card script's straggler drill at a few hundred servers: the
    port finds a thief's donors through an index of their tails and a
    clone's target through the locality sets' intersection, where the
    reference scans every idle server; every steal, clone and JCT must
    still match.  The trace keeps the 4096-server trace's load per server
    (its first 200 jobs at half the saturation rate); ``stragglers`` random
    servers run 6x slower, a new set every 10 slots."""
    trace = ref_traces.generate("bursty", n_servers=m, n_jobs=1000,
                                total_tasks=round(4_655_227 * m / 4096), seed=0)
    head = sorted(trace, key=lambda j: (j.arrival, j.job_id))[:200]
    jobs = ref_traces.replay_client(head, qps=0.5 * ref_traces.saturation_qps(head, m))
    horizon = ref_runtime.SchedulingEngine(
        m, ref_runtime.make_policy("wf"), step_mode="event").run(jobs).makespan
    rng = np.random.default_rng(40)
    events = []
    for slot in range(5, horizon, 10):
        for s in sorted(rng.choice(m, stragglers, replace=False).tolist()):
            events.append(ref_runtime.ServerEvent(slot, "slowdown", s, factor=6.0))
            events.append(ref_runtime.ServerEvent(slot + 10, "speedup", s))
    got, _ = _both(jobs, m, events=tuple(events), stealing=True, speculation=True)
    assert got.steals > 50 and got.speculations > 10 and got.spec_cancels > 0


def test_wf_torch_steals_and_speculates_like_host_wf():
    """The device assigner places every stolen fragment and retry as the
    reference's host WF does."""
    ref_jobs = ref_traces.replay_client(
        ref_traces.generate("bursty", n_jobs=20, seed=5, total_tasks=20_000), qps=0.5)
    m = _n_servers(ref_jobs)
    events = tuple(ref_runtime.ServerEvent(s, "slowdown", (s // 30) % m, factor=6.0)
                   for s in range(10, 200, 30))
    got, _ = _both(ref_jobs, m, assign="wf_torch", events=events, stealing=True,
                   speculation=True)
    assert got.steals > 0 and got.speculations > 0


def test_min_gain_threshold_blocks_worthless_steals():
    jobs, m, events = _straggler_trace()
    got, _ = _both(jobs, m, events=events, stealing=True,
                   resilience=ref_runtime.ResilienceConfig(steal_min_gain=10**6))
    assert got.steals == 0 and len(got.jct) == len(jobs)


def test_spec_pair_survives_clone_side_faults():
    jobs, m, events = _straggler_trace()
    fault = tuple(ref_runtime.ServerEvent(s, "fail", (s // 7) % m) for s in range(20, 90, 7))
    fault += tuple(ref_runtime.ServerEvent(s + 3, "recover", (s // 7) % m)
                   for s in range(20, 90, 7))
    got, _ = _both(jobs, m, events=tuple(sorted(events + fault, key=lambda e: e.slot)),
                   speculation=True)
    assert len(got.jct) + len(got.failed_jobs) == len(jobs)


def test_steal_racing_rack_failure_with_retry():
    jobs, m, events = _straggler_trace()
    rack = ref_traces.rack_failure_timeline(tuple(range(m // 2)), fail_at=25, recover_at=60)
    got, _ = _both(jobs, m, events=tuple(sorted(events + rack, key=lambda e: e.slot)),
                   stealing=True, resilience=ref_runtime.ResilienceConfig(retry=True))
    assert len(got.jct) + len(got.failed_jobs) == len(jobs)


def test_speculation_respects_pair_budget_and_job_quota():
    ref_jobs, m, events = _straggler_trace()
    plane = ControlPlane(m, policy="wf", events=convert.from_reference_events(events),
                         speculation=True,
                         resilience=ResilienceConfig(spec_budget=2, spec_job_quota=1),
                         debug=True)
    peak_pairs = 0
    orig = plane._spec_scan

    def watched():
        nonlocal peak_pairs
        orig()
        peak_pairs = max(peak_pairs, len(plane._pairs))

    plane._spec_scan = watched
    plane.submit_many(convert.from_reference_jobs(ref_jobs))
    res = plane.drain()
    assert res.speculations > 0
    assert peak_pairs <= 2
    assert all(n <= 1 for n in plane._res.spec_launched.values())


# ---- the feedback state on its own -------------------------------------------------


def test_steal_backoff_grows_exponentially_and_resets_on_win():
    cfg = ResilienceConfig()
    st = ResilienceState(cfg, n_servers=4)
    waits = []
    for _ in range(7):
        st.steal_missed(0, 0)
        waits.append(int(st.steal_wait[0]))
    assert waits == [min(cfg.steal_backoff_base << i, cfg.steal_backoff_max) for i in range(7)]
    assert not st.steal_ready(0, waits[-1] - 1) and st.steal_ready(0, waits[-1])
    st.steal_won(0)
    assert st.steal_ready(0, 0)
    assert st.metrics.counter("steal.rejected") == 7


def test_spec_budget_adapts_like_the_reference():
    """The private registry's clone win rate steers the budget: the same
    outcome stream gives the reference's budget after every window."""
    kw = dict(spec_adapt_every=10, spec_adapt_samples=4)
    st = ResilienceState(ResilienceConfig(**kw), n_servers=2)
    ref = ref_runtime.ResilienceState(ref_runtime.ResilienceConfig(**kw), n_servers=2)
    rng = np.random.default_rng(0)
    outcomes = ("spec.won_clone", "spec.won_original", "spec.aborted")
    for window in range(1, 120):
        for _ in range(int(rng.integers(0, 8))):
            name = outcomes[int(rng.integers(0, 3))] if window % 40 < 20 else outcomes[0]
            st.record_spec_outcome(name)
            ref.record_spec_outcome(name)
        st.ticks = ref.ticks = window * 10
        assert st.adapted_spec_budget() == ref.adapted_spec_budget()
    cfg = ResilienceConfig(**kw)
    assert cfg.spec_budget_min <= st.spec_budget <= cfg.spec_budget_max


def test_resilience_config_converts_field_for_field():
    ref = ref_runtime.ResilienceConfig(retry=True, spec_factor=3.0, lag_shed_budget=99)
    got = convert.from_reference_resilience(ref)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert [f.name for f in dataclasses.fields(got)] == [
        f.name for f in dataclasses.fields(ref)]


def test_metrics_registry_matches_reference():
    """The private registry the speculation budget reads: counters,
    gauges and power-of-two histograms as the reference's."""
    from repro.obs.metrics import Metrics as RefMetrics
    from repro_torch.obs.metrics import Metrics

    got, want = Metrics(), RefMetrics()
    rng = np.random.default_rng(1)
    for _ in range(300):
        name = ("spec.won_clone", "steal.rejected", "queue.depth")[int(rng.integers(0, 3))]
        value = int(rng.integers(-3, 5000))
        for m in (got, want):
            m.inc(name, value % 7)
            m.observe(name, value)
            m.set_gauge(name, value / 3)
    assert got.counters == want.counters and got.gauges == want.gauges
    for name, hist in want.histograms.items():
        mine = got.histogram(name)
        assert mine.buckets.tolist() == hist.buckets.tolist()
        assert mine.summary() == hist.summary()
        assert [mine.quantile(q) for q in (0.1, 0.5, 0.99)] == [
            hist.quantile(q) for q in (0.1, 0.5, 0.99)]
    assert got.counter("none") == 0 and got.histogram("none") is None
