"""The port's event-stepped control plane against its own slot loop and
the reference's plane.

The same seeded trace (the reference's jobs and timeline through
``convert``) runs through the port's ``SchedulingEngine`` in slot mode,
in ``step_mode="event"`` (every tick invariant-checked), and through the
reference's engine in event mode: the JCT map, makespan, failed set and
reassignment count are identical — across scenarios, orderings and the
assigners ``wf``, ``wf_torch``, ``rd``, ``rd_torch``, ``obta`` and
``rd_plus`` (the device assigners run their plain versions on the CPU;
the reference's counterpart is its host algorithm of the same name), and
under fault timelines, post-termination events, zero-task jobs and idle
gaps.  Then the streaming surface (``submit`` / ``step_until``),
``ControlPlane(scenario=...)`` and ``step_mode`` validation.
"""

import math

import numpy as np
import pytest
import torch

import repro.runtime as ref_runtime
import repro.traces as ref_traces
from repro.core import Job as RefJob
from repro.core import TaskGroup as RefTaskGroup
from repro_torch import backend, convert
from repro_torch.core import Job, TaskGroup
from repro_torch.core import rd_torch
from repro_torch.runtime import ControlPlane, SchedulingEngine, SimResult, make_policy
from repro_torch.traces import generate, poisson_client, replay_client

# the reference algorithm each port assigner is held to
REF_ASSIGN = {"wf": "wf", "wf_torch": "wf", "rd": "rd", "rd_torch": "rd",
              "obta": "obta", "rd_plus": "rd_plus"}
SMALL = dict(n_jobs=30, total_tasks=3_000, n_servers=40)
# the device RD's plain iteration costs ~1 ms a step on the CPU
TINY = dict(n_jobs=10, total_tasks=300, n_servers=16)


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


def _same(got, want):
    assert got.jct == want.jct
    assert got.makespan == want.makespan
    assert got.failed_jobs == want.failed_jobs
    assert got.reassignments == want.reassignments
    assert len(got.overhead_s) == len(want.overhead_s)


def _equiv(ref_jobs, n_servers, *, events=(), assign="wf", ordering="fifo"):
    """Port slot ≡ port event ≡ reference event on one trace; returns the
    port's (slot, event) results."""
    jobs = convert.from_reference_jobs(ref_jobs)
    port_events = convert.from_reference_events(events)
    want = ref_runtime.SchedulingEngine(
        n_servers, ref_runtime.make_policy(REF_ASSIGN[assign], ordering),
        events=events, step_mode="event",
    ).run(ref_jobs)
    rd_torch.reset_counts()
    slot = SchedulingEngine(
        n_servers, make_policy(assign, ordering), events=port_events
    ).run(jobs)
    event = SchedulingEngine(
        n_servers, make_policy(assign, ordering), events=port_events,
        step_mode="event", on_slot=_check_invariant,
    ).run(jobs)
    _same(slot, want)
    _same(event, want)
    assert rd_torch.COUNTS["host_reruns"] == 0
    return slot, event


# ---- the scenario × ordering × assigner matrix --------------------------------


@pytest.mark.parametrize("ordering", ["fifo", "ocwf", "ocwf-acc", "setf"])
@pytest.mark.parametrize("scenario", ["alibaba", "bursty", "pareto_diurnal"])
def test_event_mode_matches_slot_mode_and_reference(scenario, ordering):
    ref_jobs = ref_traces.generate(scenario, seed=7, **SMALL)
    _equiv(ref_jobs, SMALL["n_servers"], assign="wf_torch", ordering=ordering)


@pytest.mark.parametrize("ordering", ["fifo", "setf"])
@pytest.mark.parametrize("assign", ["wf", "rd", "obta"])
def test_event_mode_identical_across_host_assigners(assign, ordering):
    ref_jobs = ref_traces.generate("bursty", seed=3, **SMALL)
    _equiv(ref_jobs, SMALL["n_servers"], assign=assign, ordering=ordering)


@pytest.mark.parametrize("ordering", ["fifo", "ocwf-acc", "setf"])
@pytest.mark.parametrize("assign", ["rd_torch", "rd_plus"])
def test_event_mode_identical_with_the_device_rd(assign, ordering):
    ref_jobs = ref_traces.generate("pareto_diurnal", seed=5, **TINY)
    _equiv(ref_jobs, TINY["n_servers"], assign=assign, ordering=ordering)


# ---- faults, post-termination events, edge traces ------------------------------


@pytest.mark.parametrize("assign,ordering", [
    ("wf_torch", "fifo"), ("wf_torch", "ocwf-acc"), ("obta", "setf"),
])
def test_event_mode_identical_under_fault_timeline(assign, ordering):
    ref_jobs = ref_traces.generate("bursty", seed=9, **SMALL)
    events = (
        ref_runtime.ServerEvent(3, "slowdown", 0, factor=4.0),
        ref_runtime.ServerEvent(25, "fail", 1),
        ref_runtime.RackEvent(40, "fail", (5, 6, 7)),
        ref_runtime.ServerEvent(60, "recover", 1),
        ref_runtime.RackEvent(70, "recover", (5, 6, 7)),
        ref_runtime.ServerEvent(80, "speedup", 0),
        ref_runtime.ServerEvent(10_000, "fail", 2),  # after quiescence: dropped
    )
    slot, _ = _equiv(ref_jobs, SMALL["n_servers"], events=events, assign=assign,
                     ordering=ordering)
    assert slot.reassignments > 0


def test_device_rd_reassigns_stranded_fragments_without_host_reruns():
    ref_jobs = ref_traces.generate("bursty", seed=4, **TINY)  # one burst at slot 9
    events = (ref_runtime.ServerEvent(11, "fail", 1), ref_runtime.ServerEvent(12, "fail", 6))
    slot, _ = _equiv(ref_jobs, TINY["n_servers"], events=events, assign="rd_torch")
    assert slot.reassignments > 0


def test_event_mode_drops_post_termination_events_like_slot_loop():
    ref_jobs = [RefJob(job_id=0, arrival=0, groups=(RefTaskGroup(6, (0, 1)),),
                       mu=np.full(2, 2, np.int64))]
    slot, event = _equiv(ref_jobs, 2, events=(ref_runtime.ServerEvent(500, "fail", 0),))
    assert event.failed_jobs == []


def test_event_mode_empty_and_zero_task_jobs():
    mu = np.full(3, 2, np.int64)
    ref_jobs = [
        RefJob(job_id=0, arrival=4, groups=(), mu=mu),
        RefJob(job_id=1, arrival=4, groups=(RefTaskGroup(5, (0, 2)),), mu=mu),
    ]
    _, event = _equiv(ref_jobs, 3, assign="wf_torch")
    assert event.jct[0] == 0


def test_event_mode_idle_gaps_are_skipped_but_schedule_matches():
    mu = np.full(2, 2, np.int64)
    ref_jobs = [
        RefJob(job_id=0, arrival=0, groups=(RefTaskGroup(4, (0,)),), mu=mu),
        RefJob(job_id=1, arrival=900, groups=(RefTaskGroup(4, (1,)),), mu=mu),
    ]
    slot, event = _equiv(ref_jobs, 2, assign="wf_torch")
    assert event.makespan == slot.makespan == 902


def _random_trace(seed):
    rng = np.random.default_rng(seed)
    m = int(rng.integers(2, 8))
    mu = rng.integers(1, 4, m).astype(np.int64)
    jobs = []
    for j in range(int(rng.integers(1, 12))):
        groups = tuple(
            RefTaskGroup(
                int(rng.integers(1, 9)),
                tuple(sorted(rng.choice(m, size=int(rng.integers(1, m + 1)),
                                        replace=False).tolist())),
            )
            for _ in range(int(rng.integers(0, 4)))
        )
        jobs.append(RefJob(job_id=j, arrival=int(rng.integers(0, 20)), groups=groups, mu=mu))
    return jobs, m


@pytest.mark.parametrize("ordering", ["fifo", "ocwf-acc", "setf"])
def test_random_traces_equivalent(ordering):
    """The reference suite's seeded sweep: bursts, empty groups, zero-task
    jobs, arrival gaps."""
    for seed in range(25):
        jobs, m = _random_trace(seed)
        _equiv(jobs, m, assign="wf_torch", ordering=ordering)


# ---- the streaming surface -------------------------------------------------------


def test_control_plane_streaming_submit_and_step_until_matches_reference():
    ref_jobs = ref_traces.poisson_client("bursty", qps=0.5, n_jobs=20, seed=1,
                                         total_tasks=2_000, n_servers=30)
    jobs = convert.from_reference_jobs(ref_jobs)
    m = _n_servers(jobs)
    late = dict(job_id=999, arrival=0, mu=np.asarray(ref_jobs[0].mu))
    results = []
    for plane, job_cls, group_cls in (
        (ref_runtime.ControlPlane(m, policy="wf"), RefJob, RefTaskGroup),
        (ControlPlane(m, policy="wf_torch", debug=True, on_slot=_check_invariant),
         Job, TaskGroup),
    ):
        subs = ref_jobs if job_cls is RefJob else jobs
        plane.submit_many(subs[:10])
        plane.step_until(15)
        assert plane.now == 15
        plane.submit_many(subs[10:])
        first = plane.drain()
        assert set(first.jct) == {j.job_id for j in jobs}
        # a job submitted after its nominal arrival arrives "now", billed
        # from its nominal arrival
        t = plane.submit(job_cls(groups=(group_cls(2, tuple(range(m))),), **late))
        assert t >= plane.now
        res = plane.drain()
        assert res.jct[999] >= t + 1
        results.append(res)
    _same(results[1], results[0])


@pytest.mark.parametrize("policy,ordering", [("wf_torch", "fifo"), ("obta", "setf")])
def test_control_plane_scenario_by_name_matches_reference(policy, ordering):
    kw = {"n_jobs": 15, "seed": 4, "total_tasks": 1_500, "n_servers": 30}
    want = ref_runtime.ControlPlane(policy=REF_ASSIGN[policy], ordering=ordering,
                                    scenario="bursty", scenario_kw=kw).drain()
    got = ControlPlane(policy=policy, ordering=ordering, scenario="bursty",
                       scenario_kw=kw).drain()
    _same(got, want)
    assert len(got.jct) == 15
    slot = SchedulingEngine(30, make_policy(policy, ordering)).run(generate("bursty", **kw))
    assert got.jct == slot.jct


def test_control_plane_rejects_bad_config():
    with pytest.raises(KeyError):
        ControlPlane(scenario="no-such-scenario")
    with pytest.raises(ValueError, match="n_servers"):
        ControlPlane()
    with pytest.raises(ValueError, match="scenario"):
        ControlPlane(4, scenario_kw={"n_jobs": 3})
    with pytest.raises(ValueError, match="router"):
        ControlPlane(4).submit_request(8)


def test_step_mode_validation():
    with pytest.raises(ValueError, match="step_mode"):
        SchedulingEngine(4, step_mode="tick")
    with pytest.raises(ValueError, match="event"):
        SchedulingEngine(4, stealing=True)
    with pytest.raises(ValueError, match="event"):
        SchedulingEngine(4, speculation=True)


def test_empty_result_metrics_are_nan_not_zero():
    res = SimResult(jct={}, overhead_s=[], makespan=0, failed_jobs=[])
    assert math.isnan(res.mean_jct)
    assert math.isnan(res.jct_percentile(99))
    v, cdf = res.jct_cdf()
    assert v.size == 0 and cdf.size == 0
    res = SimResult(jct={1: 4, 2: 8}, overhead_s=[], makespan=9, failed_jobs=[])
    assert res.mean_jct == 6.0 and res.jct_percentile(50) == 6.0
    v, cdf = res.jct_cdf()
    assert v.tolist() == [4, 8] and cdf.tolist() == [0.5, 1.0]


def test_replay_and_poisson_clients_feed_the_plane_like_the_reference():
    ref_base = ref_traces.generate("bursty", n_jobs=12, seed=2, total_tasks=1_200,
                                   n_servers=24)
    base = convert.from_reference_jobs(ref_base)
    for client, ref_client in (
        (lambda js: replay_client(js, qps=2.0), lambda js: ref_traces.replay_client(js, qps=2.0)),
        (lambda js: poisson_client(js, qps=1.0, seed=3),
         lambda js: ref_traces.poisson_client(js, qps=1.0, seed=3)),
    ):
        jobs, ref_jobs = client(base), ref_client(ref_base)
        assert [(j.job_id, j.arrival) for j in jobs] == [(j.job_id, j.arrival) for j in ref_jobs]
        _equiv(ref_jobs, 24, assign="wf_torch")


# ---- the façade and the sanitizers ---------------------------------------------


@pytest.mark.parametrize("assign,reorder,events", [
    ("water_filling", False, ()),
    ("water_filling", True, ((1, "fail", 0), (6, "recover", 0))),
    ("obta", False, ((0, "slowdown", 2, 4.0),)),
    ("water_filling", False, ((1, "fail", 5),)),
], ids=["fifo", "reorder+fault", "obta+slowdown", "data-loss"])
def test_cluster_simulator_matches_reference(assign, reorder, events):
    import repro.core as ref_core
    from repro_torch import core
    from repro_torch.runtime import ClusterSimulator, ServerEvent

    ref_jobs = ref_traces.generate("alibaba", n_jobs=20, total_tasks=2_000, n_servers=20,
                                   seed=1)
    ref_jobs.append(RefJob(job_id=99, arrival=0, groups=(RefTaskGroup(40, (5,)),),
                           mu=np.full(20, 4)))
    ref_events = tuple(ref_runtime.ServerEvent(*e) for e in events)
    want = ref_runtime.ClusterSimulator(20, getattr(ref_core, assign), reorder=reorder,
                                        events=ref_events).run(ref_jobs)
    got = ClusterSimulator(20, getattr(core, assign), reorder=reorder,
                           events=tuple(ServerEvent(*e) for e in events)).run(
        convert.from_reference_jobs(ref_jobs))
    _same(got, want)
    assert ClusterSimulator(20).assign is core.water_filling


def test_sanitizers_check_the_heap_and_switch_debug_on():
    import heapq

    from repro_torch.analysis import runtime as sanitizers

    heap = []
    for key in ((3, 1, 0), (1, 3, 1), (1, 0, 2)):
        heapq.heappush(heap, (*key, object()))
    sanitizers.check_event_heap(heap)
    for bad, match in (
        ([(1, 0, 0, None), (1, 0, 0, None)], "duplicate"),
        ([(2, 0, 0, None), (1, 0, 1, None)], "heap property"),
        ([(1.5, 0, 0, None)], "non-integer"),
        ([(1, 0)], "tuple"),
    ):
        with pytest.raises(sanitizers.SanitizerError, match=match):
            sanitizers.check_event_heap(bad)
    assert not sanitizers.enabled()
    sanitizers.enable()
    try:
        assert ControlPlane(4).debug and ControlPlane(4).engine.cluster.debug
    finally:
        sanitizers.disable()
    assert not ControlPlane(4).debug


def test_buffer_guard_catches_aliases_and_leaked_mutations():
    from repro_torch.analysis.runtime import BufferGuard, SanitizerError

    pos = np.arange(4, dtype=np.int64)
    guard = BufferGuard()
    with pytest.raises(SanitizerError, match="aliases"):
        guard.capture("pos", pos, torch.from_numpy(pos))
    dev = torch.tensor(pos)  # a copy
    guard.capture("pos", pos, dev)
    pos += 1  # the host may move on; the copy must not
    guard.verify()
    dev = torch.tensor(pos)
    guard.capture("pos", pos, dev)
    dev += 1  # an in-place change reaching the handed-over value
    with pytest.raises(SanitizerError, match="changed"):
        guard.verify()
    assert len(guard) == 0
