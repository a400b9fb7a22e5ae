"""The port's traces against the reference's: the ``pareto_diurnal``
scenario, the open-loop clients, the resilience drills, and every
scenario with a placement store (``store=``)."""

import numpy as np
import pytest

import repro.placement as ref_placement
import repro.traces as ref_traces
from repro_torch import convert
from repro_torch.placement import PlacedJob, PlacementStore
from repro_torch.traces import (
    generate,
    list_scenarios,
    overload_client,
    poisson_client,
    rack_failure_timeline,
    replay_client,
    saturation_qps,
)


def _fields(job):
    return (job.job_id, job.arrival, [(g.size, g.servers) for g in job.groups],
            np.asarray(job.mu).tolist(), getattr(job, "blocks", None))


def _same_jobs(got, want):
    assert [_fields(j) for j in got] == [_fields(j) for j in want]


@pytest.mark.parametrize("overrides", [
    dict(n_jobs=40, total_tasks=4_000, n_servers=40, seed=0),
    dict(n_jobs=60, total_tasks=9_000, n_servers=64, seed=3, pareto_alpha=1.1,
         diurnal_amplitude=0.95),
    dict(n_jobs=25, total_tasks=2_500, n_servers=20, seed=5, diurnal_amplitude=0.0,
         diurnal_period=50.0),
])
def test_pareto_diurnal_matches_reference(overrides):
    _same_jobs(generate("pareto_diurnal", **overrides),
               ref_traces.generate("pareto_diurnal", **overrides))


def test_pareto_diurnal_rejects_amplitude_one():
    with pytest.raises(ValueError, match="amplitude"):
        generate("pareto_diurnal", diurnal_amplitude=1.0)


def test_scenario_registry_lists_the_three_synthetic_scenarios():
    assert list_scenarios() == ["alibaba", "bursty", "pareto_diurnal"]
    assert set(list_scenarios()) == set(ref_traces.list_scenarios()) - {"cluster_v2017"}


@pytest.mark.parametrize("scenario", ["alibaba", "bursty", "pareto_diurnal"])
def test_scenarios_with_a_store_match_reference(scenario):
    """Placement-backed jobs: the same blocks, replica sets and RNG stream
    (so the same jobs as the frozen trace), and the stores agree."""
    kw = dict(n_jobs=20, total_tasks=2_000, n_servers=30, seed=4)
    ref_store, store = ref_placement.PlacementStore(30), PlacementStore(30)
    want = ref_traces.generate(scenario, store=ref_store, **kw)
    got = generate(scenario, store=store, **kw)
    assert all(isinstance(j, PlacedJob) for j in got)
    _same_jobs(got, want)
    _same_jobs(convert.from_reference_jobs(want), want)
    assert store.snapshot() == ref_store.snapshot() and store.version == ref_store.version
    frozen = generate(scenario, **kw)
    assert [_fields(j)[:4] for j in frozen] == [_fields(j)[:4] for j in got]
    with pytest.raises(ValueError, match="spans"):
        generate(scenario, store=PlacementStore(7), **kw)


def test_replay_client_matches_reference():
    base = ref_traces.generate("bursty", n_jobs=30, total_tasks=3_000, n_servers=40, seed=2)
    for qps, start in ((2.0, 0), (0.3, 17), (5.5, 4)):
        _same_jobs(replay_client(convert.from_reference_jobs(base), qps=qps, start=start),
                   ref_traces.replay_client(base, qps=qps, start=start))
    with pytest.raises(ValueError, match="qps"):
        replay_client([], qps=0)


@pytest.mark.parametrize("kwargs", [
    dict(qps=0.5, n_jobs=20, seed=1, total_tasks=2_000, n_servers=30),
    dict(qps=3.0, seed=7, n_jobs=None, total_tasks=1_500, n_servers=20, start=9),
])
@pytest.mark.parametrize("scenario", ["bursty", "pareto_diurnal"])
def test_poisson_client_by_scenario_name_matches_reference(scenario, kwargs):
    _same_jobs(poisson_client(scenario, **kwargs), ref_traces.poisson_client(scenario, **kwargs))


def test_poisson_client_over_a_job_list_and_with_a_store():
    base = ref_traces.generate("alibaba", n_jobs=25, total_tasks=2_500, n_servers=30, seed=6)
    _same_jobs(poisson_client(convert.from_reference_jobs(base), qps=1.0, seed=3),
               ref_traces.poisson_client(base, qps=1.0, seed=3))
    ref_store, store = ref_placement.PlacementStore(30), PlacementStore(30)
    kw = dict(qps=0.8, seed=2, n_jobs=10, total_tasks=2_000, n_servers=30)
    got = poisson_client("bursty", store=store, **kw)
    _same_jobs(got, ref_traces.poisson_client("bursty", store=ref_store, **kw))
    assert all(isinstance(j, PlacedJob) for j in got)  # re-timing keeps the class
    with pytest.raises(ValueError, match="scenario names"):
        poisson_client(convert.from_reference_jobs(base), qps=1.0, store=store)
    with pytest.raises(ValueError, match="qps"):
        poisson_client("bursty", qps=-1.0)


@pytest.mark.parametrize("rho", [0.5, 1.0, 1.5, 3.0])
def test_saturation_and_overload_client_match_reference(rho):
    base = ref_traces.generate("bursty", n_jobs=30, total_tasks=3_000, n_servers=40, seed=2)
    jobs = convert.from_reference_jobs(base)
    assert saturation_qps(jobs, 40) == ref_traces.saturation_qps(base, 40)
    _same_jobs(overload_client(jobs, rho=rho, n_servers=40, start=3),
               ref_traces.overload_client(base, rho=rho, n_servers=40, start=3))


def test_resilience_drill_validation():
    with pytest.raises(ValueError, match="non-empty"):
        saturation_qps([], 4)
    with pytest.raises(ValueError, match="rho"):
        overload_client([], rho=0.0, n_servers=4)


@pytest.mark.parametrize("servers,fail_at,recover_at", [
    ((3, 1, 2), 5, None), (tuple(range(8)), 0, 40), ((9,), 12, 13),
])
def test_rack_failure_timeline_matches_reference(servers, fail_at, recover_at):
    got = rack_failure_timeline(servers, fail_at=fail_at, recover_at=recover_at)
    want = ref_traces.rack_failure_timeline(servers, fail_at=fail_at, recover_at=recover_at)
    assert [(e.slot, e.kind, e.servers) for e in got] == [
        (e.slot, e.kind, e.servers) for e in want]
    assert [(e.slot, e.kind, e.servers) for e in convert.from_reference_events(want)] == [
        (e.slot, e.kind, e.servers) for e in want]
