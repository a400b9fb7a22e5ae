"""The port's placement store, replication policies, churn timelines and
placement-aware engine and router against the reference's.

Both stores go through the same operations and must agree on every
return value, replica set, access count, version and counter; policies
propose the same deltas; ``churn_timeline`` draws the same events; a
placement-backed trace under churn schedules identically (and leaves the
stores equal); and ``ReplicaRouter(placement=...)`` routes by model /
adapter ID as the reference's does — also from the control plane's
``submit_request``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.placement as ref_placement
import repro.runtime as ref_runtime
import repro.traces as ref_traces
from repro.serve.engine import ReplicaRouter as RefRouter
from repro_torch import backend, convert
from repro_torch.core import TaskGroup
from repro_torch.placement import (
    CheckpointManifestPolicy,
    HotBlockPolicy,
    PlacedJob,
    PlacementEvent,
    PlacementStore,
    churn_timeline,
    data_block,
    list_replication_policies,
    lora_block,
    make_replication_policy,
)
from repro_torch.runtime import ControlPlane, SchedulingEngine, make_policy
from repro_torch.serve.engine import ReplicaRouter
from repro_torch.traces import generate


@pytest.fixture(autouse=True, scope="module")
def _cpu_one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with backend.set_backend(device="cpu"):
        yield
    torch.set_num_threads(threads)


def _store_state(store):
    return (
        store.snapshot(),
        {b: store.access_count(b) for b in store.blocks()},
        store.active_servers(),
        store.version,
        store.replicas_added,
        store.replicas_evicted,
    )


def _events(evs):
    return [(e.slot, e.kind, e.block, e.server, e.seed) for e in evs]


# ---- store semantics --------------------------------------------------------------


def test_store_operations_match_reference():
    """One seeded stream of operations on both stores: same return
    values and the same state after each."""
    rng = np.random.default_rng(0)
    ref, got = ref_placement.PlacementStore(8), PlacementStore(8)
    for i in range(6):
        seed = int(rng.integers(0, 2**31 - 1))
        assert got.place_block(
            f"b{i}", np.random.default_rng(seed), zipf_alpha=1.0, avail_lo=2, avail_hi=4
        ) == ref.place_block(
            f"b{i}", np.random.default_rng(seed), zipf_alpha=1.0, avail_lo=2, avail_hi=4
        )
    for _ in range(60):
        op = int(rng.integers(0, 6))
        block = f"b{int(rng.integers(0, 6))}"
        server = int(rng.integers(0, 8))
        calls = {
            0: lambda s: s.add_replica(block, server) if s._active[server] else None,
            1: lambda s: s.evict(block, server),
            2: lambda s: s.record_access(block, server + 1),
            3: lambda s: s.server_leave(server),
            4: lambda s: s.server_join(server),
            5: lambda s: s.blocks_on(server),
        }
        assert calls[op](got) == calls[op](ref)
        assert _store_state(got) == _store_state(ref)
    assert _store_state(convert.from_reference_store(ref)) == _store_state(ref)


def test_store_rejects_bad_inputs_and_resolves_eligible_sets():
    store = PlacementStore(4)
    with pytest.raises(ValueError):
        store.add_block("b", ())
    with pytest.raises(ValueError):
        store.add_block("b", (4,))
    store.add_block("b", (0, 1))
    with pytest.raises(ValueError):
        store.add_block("b", (1,))
    with pytest.raises(KeyError):
        store.replicas("nope")
    store.add_block("c", (1, 2))
    assert store.eligible("b", "c") == (1,)
    store.add_block("d", (3,))
    with pytest.raises(ValueError, match="no server holds"):
        store.eligible("b", "d")
    assert store.evict("d", 3) and store.replicas("d") == ()  # data lost


@pytest.mark.parametrize("policy", [
    HotBlockPolicy(max_replicas=3, min_replicas=2, add_budget=2),
    HotBlockPolicy(max_replicas=4, min_replicas=1, add_budget=3, evict_budget=2),
], ids=["repair+hot", "with-evictions"])
def test_replication_policies_propose_the_reference_deltas(policy):
    rng = np.random.default_rng(3)
    ref = ref_placement.PlacementStore(
        10, policy=ref_placement.HotBlockPolicy(**policy.__dict__))
    for i in range(12):
        ref.place_block(f"b{i}", rng, zipf_alpha=1.2, avail_lo=1, avail_hi=3)
        ref.record_access(f"b{i}", int(rng.integers(0, 50)))
    ref.evict("b0", ref.replicas("b0")[0]) if len(ref.replicas("b0")) > 1 else None
    got = convert.from_reference_store(ref)
    assert got.policy == policy
    for step in range(4):
        d_ref = ref.rebalance(np.random.default_rng(step))
        d_got = got.rebalance(np.random.default_rng(step))
        assert (d_got.added, d_got.evicted) == (d_ref.added, d_ref.evicted)
        assert _store_state(got) == _store_state(ref)


def test_policy_registry_and_static_noop():
    assert list_replication_policies() == ["checkpoint", "hot-block", "static"]
    assert make_replication_policy("checkpoint") == CheckpointManifestPolicy()
    with pytest.raises(KeyError):
        make_replication_policy("no-such-policy")
    with pytest.raises(TypeError):
        make_replication_policy(42)
    store = PlacementStore(4)
    store.add_block("a", (0, 1))
    before = (store.snapshot(), store.version)
    assert not store.rebalance(np.random.default_rng(7))
    assert (store.snapshot(), store.version) == before


@pytest.mark.parametrize("rebalance_every,evict_rate", [(0, 0.3), (5, 0.3), (4, 0.0)])
def test_churn_timeline_matches_reference(rebalance_every, evict_rate):
    ref = ref_placement.PlacementStore(8)
    rng = np.random.default_rng(0)
    for i in range(6):
        ref.place_block(f"b{i}", rng, zipf_alpha=1.0, avail_lo=2, avail_hi=4)
    kw = dict(horizon=50, rebalance_every=rebalance_every, evict_rate=evict_rate, seed=1)
    want = ref_placement.churn_timeline(ref, **kw)
    got = churn_timeline(convert.from_reference_store(ref), **kw)
    assert _events(got) == _events(want)
    assert _events(convert.from_reference_events(want)) == _events(want)


def test_placement_event_validation():
    with pytest.raises(ValueError):
        PlacementEvent(0, "explode")
    with pytest.raises(ValueError):
        PlacementEvent(0, "evict", block="b")
    with pytest.raises(ValueError):
        PlacementEvent(0, "leave")
    with pytest.raises(ValueError, match="placement events require"):
        SchedulingEngine(4, "wf", events=(PlacementEvent(1, "join", server=0),))


# ---- the engine under placement churn ---------------------------------------------


@pytest.mark.parametrize("scenario", ["bursty", "pareto_diurnal"])
def test_static_store_reproduces_frozen_schedules(scenario):
    kw = dict(n_jobs=24, total_tasks=3_000, n_servers=20, seed=7)
    frozen = generate(scenario, **kw)
    store = PlacementStore(20)
    placed = generate(scenario, store=store, **kw)
    assert all(isinstance(j, PlacedJob) for j in placed)
    base = SchedulingEngine(20, make_policy("wf_torch")).run(frozen)
    via_store = SchedulingEngine(20, make_policy("wf_torch"), placement=store,
                                 debug=True).run(placed)
    assert (base.jct, base.makespan) == (via_store.jct, via_store.makespan)


@pytest.mark.parametrize("repl_policy,assign,ordering,step_mode", [
    ("static", "wf_torch", "fifo", "slot"),
    ("hot-block", "wf_torch", "fifo", "event"),
    ("hot-block", "wf", "ocwf-acc", "event"),
    ("hot-block", "obta", "setf", "slot"),
])
def test_churned_run_matches_reference(repl_policy, assign, ordering, step_mode):
    """A placement-backed bursty trace under rebalances and replica
    evictions: the same schedule, reassignments and failed set, and the
    stores end in the same state."""
    ref_store = ref_placement.PlacementStore(20, policy=repl_policy)
    ref_jobs = ref_traces.generate("bursty", store=ref_store, n_jobs=24, total_tasks=3_000,
                                   n_servers=20, seed=7, avail_lo=2, avail_hi=4)
    store = convert.from_reference_store(ref_store)
    jobs = convert.from_reference_jobs(ref_jobs)
    assert all(isinstance(j, PlacedJob) for j in jobs)
    horizon = max(j.arrival for j in jobs) + 300
    ref_events = ref_placement.churn_timeline(ref_store, horizon=horizon, rebalance_every=4,
                                              evict_rate=0.3, seed=3)
    want = ref_runtime.SchedulingEngine(
        20, ref_runtime.make_policy("wf" if assign == "wf_torch" else assign, ordering),
        placement=ref_store, events=ref_events, step_mode=step_mode,
    ).run(ref_jobs)
    got = SchedulingEngine(
        20, make_policy(assign, ordering), placement=store,
        events=convert.from_reference_events(ref_events), step_mode=step_mode,
        debug=True, on_slot=lambda c, s: c.assert_invariant(),
    ).run(jobs)
    assert (got.jct, got.makespan, got.failed_jobs, got.reassignments) == (
        want.jct, want.makespan, want.failed_jobs, want.reassignments)
    assert store.replicas_evicted > 0  # the churn reached the store
    assert _store_state(store) == _store_state(ref_store)


def _one_block_job(store, job_id, size, servers, m=4):
    block = data_block(job_id, 0)
    store.add_block(block, servers)
    return PlacedJob(job_id, 0, (TaskGroup(size, servers),), np.full(m, 2), (block,))


@pytest.mark.parametrize("event,failed", [
    (PlacementEvent(1, "evict", block=data_block(0, 0), server=0), []),
    (PlacementEvent(1, "leave", server=0), []),
    (PlacementEvent(1, "add", block=data_block(0, 0), server=3), []),
], ids=["evict-strands", "leave", "add-widens"])
def test_single_block_placement_events(event, failed):
    store = PlacementStore(4)
    job = _one_block_job(store, 0, 40, (0, 1))
    res = SchedulingEngine(4, make_policy("wf_torch", "ocwf-acc"), placement=store,
                           events=(event,), step_mode="event", debug=True,
                           on_slot=lambda c, s: c.assert_invariant()).run([job])
    assert res.failed_jobs == failed and 0 in res.jct
    if event.kind != "add":
        assert res.reassignments > 0 and 0 not in store.replicas(data_block(0, 0))


def test_last_replica_eviction_fails_job():
    store = PlacementStore(4)
    job = _one_block_job(store, 0, 40, (2,))
    events = (PlacementEvent(1, "evict", block=data_block(0, 0), server=2),)
    res = SchedulingEngine(4, make_policy("wf_torch"), placement=store,
                           events=events).run([job])
    assert res.failed_jobs == [0] and 0 not in res.jct


# ---- routing by model / adapter ID --------------------------------------------------


def _serve_stores(n=6):
    ref = ref_placement.PlacementStore(n)
    ref.add_block(ref_placement.model_block("qwen"), (0, 1, 2, 3))
    ref.add_block(ref_placement.model_block("mamba"), (3, 4, 5))
    ref.add_block(ref_placement.lora_block("sql"), (1, 2, 5))
    return ref, convert.from_reference_store(ref)


def test_router_routes_by_model_and_adapter_like_the_reference():
    ref_store, store = _serve_stores()
    ref = RefRouter(6, tokens_per_step=64, policy="wf", placement=ref_store)
    got = ReplicaRouter(6, tokens_per_step=64, policy="wf_torch", placement=store)
    rng = np.random.default_rng(0)
    for _ in range(20):
        n = int(rng.integers(1, 300))
        model = ("qwen", "mamba")[int(rng.integers(0, 2))]
        adapter = "sql" if rng.random() < 0.5 else None
        assert got.route(n, model=model, adapter=adapter) == ref.route(
            n, model=model, adapter=adapter)
        if rng.random() < 0.3:
            ref.drain()
            got.drain()
    assert got.queued.tolist() == ref.queued.tolist()
    assert _store_state(store) == _store_state(ref_store)  # accesses recorded
    assert set(got.route(10, model="qwen", adapter="sql")) <= {1, 2}
    store.add_block(lora_block("edge"), (4,))
    with pytest.raises(ValueError, match="no server holds"):
        got.route(10, model="qwen", adapter="edge")
    with pytest.raises(ValueError, match="placement store"):
        ReplicaRouter(6).route(10, model="qwen")
    with pytest.raises(ValueError, match="spans"):
        ReplicaRouter(4, placement=store)


def test_plane_routes_requests_through_the_placement_store_like_the_reference():
    ref_store, store = _serve_stores()
    ref_plane = ref_runtime.ControlPlane(
        6, policy="wf", router=RefRouter(6, tokens_per_step=32, placement=ref_store))
    plane = ControlPlane(
        6, policy="wf_torch",
        router=ReplicaRouter(6, tokens_per_step=32, policy="wf_torch", placement=store))
    for p in (ref_plane, plane):
        for i in range(8):
            p.submit_request(40 + 17 * i, at=i // 2, model=("qwen", "mamba")[i % 2],
                             adapter="sql" if i % 3 == 0 else None)
    want, got = ref_plane.drain(), plane.drain()
    assert got.serve_latency == want.serve_latency and got.serve_latency
    assert got.makespan == want.makespan
    assert _store_state(store) == _store_state(ref_store)


# ---- checkpoint-derived serve routing (placement.checkpoint) ------------------


def _tiny_checkpoint(directory, writer, step=3):
    """The reference's test tree ({"w": (2, 3), "b": (3,)} float32),
    written by ``writer`` (either package's ``save_checkpoint``)."""
    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": np.zeros(3, dtype=np.float32)}
    return writer(str(directory), step, tree)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_register_checkpoint_places_and_routes_like_the_reference(tmp_path, writer):
    """A checkpoint written by either package registers in both packages'
    stores with the same info and replicas; the routers then resolve the
    same eligible sets and route the same tokens; the ``checkpoint``
    policy re-replicates the same way."""
    from repro.checkpoint.store import save_checkpoint as ref_save
    from repro.placement import register_checkpoint as ref_register
    from repro.placement import scan_checkpoints as ref_scan
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.placement import register_checkpoint, scan_checkpoints

    save = save_checkpoint if writer == "port" else ref_save
    for name in ("qwen", "sql-lora", "solo"):
        _tiny_checkpoint(tmp_path / name, save)
    stores = (ref_placement.PlacementStore(4, policy="checkpoint"),
              PlacementStore(4, policy="checkpoint"))
    for store, register in zip(stores, (ref_register, register_checkpoint)):
        info = register(store, str(tmp_path / "qwen"), servers=(0, 1, 3))
        assert (info.block, info.step, info.n_leaves, info.n_params) == ("model/qwen", 3, 2, 9)
        register(store, str(tmp_path / "sql-lora"), servers=(1, 2, 3), kind="lora")
        register(store, str(tmp_path / "solo"), servers=(0,))
        with pytest.raises(FileNotFoundError):
            register(store, str(tmp_path / "missing"), servers=(0,))
    assert _store_state(stores[1]) == _store_state(stores[0])
    assert ([dataclasses.astuple(i) for i in scan_checkpoints(str(tmp_path))]
            == [dataclasses.astuple(i) for i in ref_scan(str(tmp_path))])
    ref = RefRouter(4, tokens_per_step=100, placement=stores[0])
    got = ReplicaRouter(4, tokens_per_step=100, policy="wf_torch", placement=stores[1])
    for n, model, adapter in ((150, "qwen", "sql-lora"), (90, "qwen", None)):
        assert got.route(n, model=model, adapter=adapter) == ref.route(
            n, model=model, adapter=adapter)
    with pytest.raises(ValueError, match="no server holds all"):
        got.route(10, model="solo", adapter="sql-lora")
    for store in stores:
        store.evict("model/solo", 0) if len(store.replicas("model/solo")) > 1 else None
        store.evict("model/qwen", 0)
    deltas = [store.rebalance() for store in stores]
    assert (deltas[1].added, deltas[1].evicted) == (deltas[0].added, deltas[0].evicted)
    assert _store_state(stores[1]) == _store_state(stores[0])


def test_register_checkpoint_rejects_a_malformed_manifest(tmp_path):
    import json

    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.placement import register_checkpoint

    _tiny_checkpoint(tmp_path / "broken", save_checkpoint)
    manifest_path = tmp_path / "broken" / "step_00000003" / "manifest.json"
    manifest = json.loads(manifest_path.read_text())
    del manifest["leaves"][0]["crc32"]
    manifest_path.write_text(json.dumps(manifest))
    store = PlacementStore(4)
    with pytest.raises(ValueError, match="crc32"):
        register_checkpoint(store, str(tmp_path / "broken"), servers=(0,))
    assert not list(store.blocks())

