"""The port's traces against the reference's: the ``pareto_diurnal``
scenario, the open-loop clients, the resilience drills, every scenario
with a placement store (``store=``), and the ``cluster_v2017`` CSV replay
(``tests/test_traces.py``'s loader tests, the path given as ``path=``
where the reference reads an environment variable)."""

import os

import numpy as np
import pytest

import repro.placement as ref_placement
import repro.runtime as ref_runtime
import repro.traces as ref_traces
from repro_torch import convert
from repro_torch.placement import PlacedJob, PlacementStore
from repro_torch.runtime import ControlPlane, SchedulingEngine
from repro_torch.traces import (
    ClusterTraceConfig,
    generate,
    generate_cluster_trace,
    iter_batch_task_csv,
    list_scenarios,
    load_batch_task_csv,
    overload_client,
    poisson_client,
    rack_failure_timeline,
    replay_client,
    saturation_qps,
    scenario_available,
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


def test_scenario_registry_lists_the_reference_scenarios():
    assert list_scenarios() == ref_traces.list_scenarios()
    assert "cluster_v2017" in list_scenarios()


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


# ---- cluster-trace-v2017 CSV loader (tests/test_traces.py, with path=) --------

FIXTURE_CSV = os.path.join(os.path.dirname(__file__), "data", "batch_task_sample.csv")


def test_fixture_csv_loads_and_validates():
    rows = load_batch_task_csv(FIXTURE_CSV)
    # Failed/Waiting statuses and the 0-instance row are skipped
    assert len(rows) == 11
    assert all(r.status == "Terminated" for r in rows)
    assert all(r.instance_num > 0 for r in rows)
    ref_rows = ref_traces.load_batch_task_csv(FIXTURE_CSV)
    assert [tuple(vars(r).values()) for r in rows] == [tuple(vars(r).values()) for r in ref_rows]


def test_loader_missing_file_raises_with_hint():
    with pytest.raises(FileNotFoundError, match="ClusterTraceConfig.path"):
        load_batch_task_csv("/nonexistent/batch_task.csv")


def test_loader_rejects_malformed_rows(tmp_path):
    bad_cols = tmp_path / "cols.csv"
    bad_cols.write_text("1,2,j,t,5,Terminated,1\n")  # 7 columns
    with pytest.raises(ValueError, match="expected 8 columns"):
        load_batch_task_csv(str(bad_cols))
    bad_int = tmp_path / "int.csv"
    bad_int.write_text("abc,2,j,t,5,Terminated,1,1\n")
    with pytest.raises(ValueError, match="create_timestamp"):
        load_batch_task_csv(str(bad_int))
    bad_job = tmp_path / "job.csv"
    bad_job.write_text("1,2,,t,5,Terminated,1,1\n")
    with pytest.raises(ValueError, match="empty job_id"):
        load_batch_task_csv(str(bad_job))
    negative = tmp_path / "neg.csv"
    negative.write_text("1,2,j,t,-5,Terminated,1,1\n")
    with pytest.raises(ValueError, match="negative"):
        load_batch_task_csv(str(negative))


def test_loader_tolerates_header_and_blank_lines(tmp_path):
    csv_path = tmp_path / "with_header.csv"
    csv_path.write_text(
        "create_timestamp,modify_timestamp,job_id,task_id,instance_num,"
        "status,plan_cpu,plan_mem\n"
        "\n"
        "10,20,j1,t1,4,Terminated,100,0.5\n"
    )
    rows = load_batch_task_csv(str(csv_path))
    assert len(rows) == 1 and rows[0].instance_num == 4


def test_chunked_iterator_matches_whole_file_load():
    whole = load_batch_task_csv(FIXTURE_CSV)
    for chunk_rows in (1, 2, 3, 1_000):
        chunks = list(iter_batch_task_csv(FIXTURE_CSV, chunk_rows=chunk_rows))
        assert all(len(c) <= chunk_rows for c in chunks)
        assert [r for c in chunks for r in c] == whole
    with pytest.raises(ValueError, match="chunk_rows"):
        iter_batch_task_csv(FIXTURE_CSV, chunk_rows=0)
    with pytest.raises(FileNotFoundError, match="ClusterTraceConfig.path"):
        iter_batch_task_csv("/nonexistent/batch_task.csv")


def test_generate_cluster_trace_chunked_replay_identical():
    base = generate_cluster_trace(ClusterTraceConfig(path=FIXTURE_CSV, n_servers=12))
    chunked = generate_cluster_trace(
        ClusterTraceConfig(path=FIXTURE_CSV, n_servers=12, chunk_rows=2)
    )
    _same_jobs(chunked, base)


def test_generate_cluster_trace_chunked_respects_n_jobs_cap():
    base = generate_cluster_trace(ClusterTraceConfig(path=FIXTURE_CSV, n_servers=12, n_jobs=3))
    chunked = generate_cluster_trace(
        ClusterTraceConfig(path=FIXTURE_CSV, n_servers=12, n_jobs=3, chunk_rows=1)
    )
    assert len(base) == len(chunked) == 3
    _same_jobs(chunked, base)


def test_generate_cluster_trace_from_fixture_runs_end_to_end():
    cfg = ClusterTraceConfig(path=FIXTURE_CSV, n_servers=12, seconds_per_slot=30.0)
    jobs = generate_cluster_trace(cfg)
    assert len(jobs) == 5  # j_1003 is all-Failed
    assert [j.job_id for j in jobs] == list(range(5))
    assert jobs[0].arrival == 0
    assert all(a.arrival <= b.arrival for a, b in zip(jobs, jobs[1:]))
    assert [len(j.groups) for j in jobs] == [3, 2, 2, 3, 1]
    assert sum(j.n_tasks for j in jobs) == 880
    res = SchedulingEngine(12, "wf").run(jobs)
    assert sorted(res.jct) == list(range(5))


@pytest.mark.parametrize("kw", [
    dict(n_servers=12, seconds_per_slot=30.0),
    dict(n_servers=40, seconds_per_slot=5.0, seed=3, chunk_rows=2, zipf_alpha=1.3),
    dict(n_servers=9, n_jobs=4, chunk_rows=1, avail_lo=2, avail_hi=3, cap_lo=1, cap_hi=2),
])
def test_cluster_v2017_matches_reference(kw):
    _same_jobs(generate("cluster_v2017", path=FIXTURE_CSV, **kw),
               ref_traces.generate("cluster_v2017", path=FIXTURE_CSV, **kw))


def _seeded_csv(path, seed, n_jobs):
    """A headerless batch_task.csv in the published 8-column schema, drawn
    from ``seed``: 1-6 task groups a job, some rows not Terminated, some
    with 0 instances, rows out of arrival order."""
    rng = np.random.default_rng(seed)
    lines = []
    for j in range(n_jobs):
        t0 = int(rng.integers(0, 5_000))
        for k in range(int(rng.integers(1, 7))):
            status = "Terminated" if rng.random() > 0.1 else "Failed"
            n = int(rng.integers(0, 400))
            lines.append(f"{t0 + 3 * k},{t0 + 900},j_{j},task_{k},{n},{status},100,0.5")
    order = rng.permutation(len(lines))
    path.write_text("\n".join(lines[i] for i in order) + "\n")


@pytest.mark.parametrize("chunk_rows", [7, 4096])
def test_seeded_csv_two_pass_replay_matches_reference_and_one_shot(tmp_path, chunk_rows):
    """A larger CSV: the chunked two-pass replay equals the reference's and
    the jobs built from a one-shot ``load_batch_task_csv``."""
    path = tmp_path / "batch_task.csv"
    _seeded_csv(path, seed=11, n_jobs=40)
    kw = dict(path=str(path), n_servers=64, n_jobs=30, chunk_rows=chunk_rows)
    got = generate("cluster_v2017", **kw)
    _same_jobs(got, ref_traces.generate("cluster_v2017", **kw))
    assert len(got) == 30
    rows = load_batch_task_csv(str(path))
    first = {}
    for r in rows:
        first[r.job_id] = min(first.get(r.job_id, r.create_timestamp), r.create_timestamp)
    picked = sorted(first, key=lambda j: (first[j], j))[:30]
    sizes = [sorted((r.create_timestamp, r.task_id, r.instance_num) for r in rows
                    if r.job_id == j) for j in picked]
    assert [[g.size for g in job.groups] for job in got] == [[n for *_, n in s] for s in sizes]


def test_generate_cluster_trace_placement_backed():
    kw = dict(path=FIXTURE_CSV, n_servers=12, seconds_per_slot=30.0)
    frozen = generate_cluster_trace(ClusterTraceConfig(**kw))
    store, ref_store = PlacementStore(12), ref_placement.PlacementStore(12)
    placed = generate_cluster_trace(ClusterTraceConfig(**kw), store=store)
    want = ref_traces.generate("cluster_v2017", store=ref_store, **kw)
    for a, b in zip(frozen, placed):
        assert isinstance(b, PlacedJob)
        assert [(g.size, g.servers) for g in a.groups] == [(g.size, g.servers) for g in b.groups]
        assert store.replicas(b.blocks[0]) == b.groups[0].servers
    _same_jobs(placed, want)
    assert store.snapshot() == ref_store.snapshot()


def test_plane_replays_the_csv_like_the_reference():
    """The scenario by name through ``ControlPlane(scenario=...)``: the
    same JCTs as the reference's plane on the same CSV."""
    kw = dict(scenario="cluster_v2017",
              scenario_kw=dict(path=FIXTURE_CSV, n_servers=12, seconds_per_slot=30.0))
    got = ControlPlane(**kw).drain()
    want = ref_runtime.ControlPlane(**kw).drain()
    assert (got.jct, got.makespan) == (want.jct, want.makespan)


def test_build_job_rejects_missing_group_spec():
    from repro_torch.traces.placement import build_job

    with pytest.raises(ValueError, match="mean_groups > 0"):
        build_job(
            0, 0, 10, n_servers=4, zipf_alpha=1.0, avail_lo=1, avail_hi=2,
            cap_lo=1, cap_hi=2, rng=np.random.default_rng(0),
        )


def test_scenario_registry_gracefully_skips_missing_csv():
    assert not scenario_available("cluster_v2017")
    assert not scenario_available("cluster_v2017", "/nonexistent/batch_task.csv")
    with pytest.raises(FileNotFoundError, match="no cluster-trace-v2017"):
        generate("cluster_v2017")
    assert scenario_available("cluster_v2017", FIXTURE_CSV)
    assert scenario_available("bursty") and not scenario_available("no_such")
    jobs = generate("cluster_v2017", path=FIXTURE_CSV, n_servers=10, seconds_per_slot=30.0)
    assert len(jobs) == 5


def test_the_port_reads_no_environment_for_the_csv():
    import ast
    import pathlib

    import repro_torch.traces.cluster_v2017 as mod

    tree = ast.parse(pathlib.Path(mod.__file__).read_text())
    names = {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
    assert not {"environ", "getenv"} & names
    assert not hasattr(mod, "ENV_VAR")
