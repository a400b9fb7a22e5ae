"""The port's device Replica-Deletion against the reference's.

The chain of evidence for the CUDA step kernel and the ``rd_torch``
path: on the card, ``chip_smoke.py`` and ``tests/test_torch_rd_card.py``
hold the kernel bit for bit against ``rd_step_plain``; here, on the CPU,
the plain iteration's sort and walk (``rd_strip_takes_plain``) is held
against the TPU kernel's own code (``rd_strip_takes_pallas`` in
interpret mode) and the reference's jnp lexsort strip, and the whole
device RD — per instance, chained over a burst, after a slot overflow,
at group widths up to 64 and inside the scheduling engine — against
``rd_reference``, ``rd_jax`` and the host RD.  Everything is int32, so
every comparison is exact (tolerance 0).  Inputs are made with numpy
from fixed seeds and fed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.runtime as ref_runtime
import repro.traces as ref_traces
from repro import backend as ref_backend
from repro.core import AssignmentProblem as RefProblem
from repro.core import TaskGroup as RefGroup
from repro.core import rd as ref_rd
from repro.core import rd_jax
from repro.core.rd_reference import replica_deletion_reference
from repro.kernels.rd import rd_strip_takes_pallas
from repro_torch import backend, convert
from repro_torch.core import AssignmentProblem, TaskGroup, commit_busy
from repro_torch.core import rd as port_rd
from repro_torch.core import rd_torch
from repro_torch.kernels import rd as rdk
from repro_torch.runtime import SchedulingEngine, make_policy
from repro_torch.traces import generate

BIG = 2**30
STRIP_CASES = ("random", "ties", "no-candidates")


@pytest.fixture(autouse=True, scope="module")
def _cpu_one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with backend.set_backend(device="cpu"):
        yield
    torch.set_num_threads(threads)


# ---- strip level ----------------------------------------------------------------


def _key_block(rng, n_rows, n_lanes, case):
    """A strip key block as ``rd_torch`` builds it: masked ``-count``,
    alt, packed holder words, group; small ranges force deep ties."""
    keys = np.empty((n_rows, n_lanes), np.int32)
    cand = rng.random(n_lanes) < 0.4
    keys[0] = np.where(cand, -rng.integers(2, 5, n_lanes), BIG)
    keys[1] = np.where(rng.random(n_lanes) < 0.1, BIG, rng.integers(0, 4, n_lanes))
    words = rng.integers(0, 3, (n_rows - 3, n_lanes))
    keys[2:-1] = (words << 15) | rng.integers(0, 3, (n_rows - 3, n_lanes))
    keys[-1] = rng.integers(0, 3, n_lanes)
    if case == "ties":  # every key row equal: only the lane breaks ties
        keys[:] = keys[:, :1]
        keys[0] = -2
    elif case == "no-candidates":
        keys[0] = BIG
    size = rng.integers(0, 9, n_lanes).astype(np.int32)
    quota = np.int32(rng.integers(1, 40))
    return keys, size, quota


def _jnp_strip(keys, size, quota):
    """The reference's jnp strip (``rd_jax._strip``'s non-kernel branch)."""
    order = rd_jax._strip_order_jnp(
        jnp.asarray(keys[0]),
        jnp.asarray(keys[1]),
        jnp.asarray(keys[2:-1].T),
        jnp.asarray(keys[-1]),
    )
    order = np.asarray(order)
    s = np.where(keys[0][order] != BIG, size[order], 0).astype(np.int32)
    prev = np.cumsum(s, dtype=np.int32) - s
    return np.clip(quota - prev, 0, s).astype(np.int32), order.astype(np.int32)


@pytest.mark.parametrize("case", STRIP_CASES)
@pytest.mark.parametrize("n_lanes", [128, 256])
@pytest.mark.parametrize("n_rows", [4, 11])
def test_plain_strip_matches_reference_kernel_and_jnp(n_rows, n_lanes, case):
    rng = np.random.default_rng(100 * n_rows + n_lanes + STRIP_CASES.index(case))
    keys, size, quota = _key_block(rng, n_rows, n_lanes, case)
    take, idx = rd_strip_takes_pallas(
        jnp.asarray(keys), jnp.asarray(size), jnp.int32(quota), interpret=True
    )
    got_take, got_idx = rdk.rd_strip_takes_plain(
        torch.from_numpy(keys), torch.from_numpy(size), torch.tensor([quota])
    )
    assert got_take.dtype == torch.int32 and got_idx.dtype == torch.int32
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(got_take.numpy(), np.asarray(take))
    jnp_take, jnp_idx = _jnp_strip(keys, size, quota)
    np.testing.assert_array_equal(got_idx.numpy(), jnp_idx)
    np.testing.assert_array_equal(got_take.numpy(), jnp_take)


def _cpu_state(seed=3, m=12):
    """A device RD state on the CPU before its first iteration."""
    ref_problem = _random_instance(np.random.default_rng(seed), m=m, k_hi=5, size_hi=30,
                                   avail_hi=6)
    return rd_torch.initial_rd_state(convert.from_reference_problem(ref_problem))


def test_strip_wrapper_takes_plain_version_on_cpu():
    """The step wrapper takes the plain iteration for state on the CPU,
    and counts it as plain, not as a launch nor as a wide row."""
    for dedup in (False, True):
        st = _cpu_state()
        twin = st.clone()
        rdk.reset_counts()
        rdk.rd_step(st, dedup)
        assert rdk.COUNTS == {"rd_step": 0, "plain": 1, "wide": 0}
        rdk.rd_step_plain(twin, dedup)
        for name, buf in st.buffers().items():
            assert torch.equal(buf, twin.buffers()[name]), name


@pytest.mark.parametrize(
    "bad", ["dtype", "ndim", "narrow", "pow2", "rows", "wide", "size", "quota"]
)
def test_strip_wrapper_rejects_inputs_outside_the_contract(bad):
    """The step's state outside the kernel's contract is refused when it
    is built: wrong dtype or rank, slot counts off the power-of-two range
    [128, RD_MAX_C], a holder row width that is no power of two, a slot
    or server buffer of the wrong length (``quota``: the service rates
    the quota divides by)."""
    bufs = _cpu_state().buffers()
    c_slots, a = bufs["holders"].shape[0] - 1, bufs["holders"].shape[1]

    def slots(n):  # every slot buffer at n slots
        for name in ("holders", "size", "cnt", "grp", "hash"):
            t = bufs[name]
            bufs[name] = t.new_zeros((n + 1, *t.shape[1:]))

    if bad == "dtype":
        bufs["holders"] = bufs["holders"].long()
    elif bad == "ndim":
        bufs["holders"] = bufs["holders"][:, 0].contiguous()
    elif bad == "narrow":
        slots(rdk.MIN_LANES // 2)
    elif bad == "pow2":
        slots(192)
    elif bad == "rows":
        bufs["holders"] = bufs["holders"].new_zeros((c_slots + 1, a + 1))
    elif bad == "wide":
        slots(2 * rdk.RD_MAX_C)
    elif bad == "size":
        bufs["size"] = bufs["size"][:-1].contiguous()
    elif bad == "quota":
        bufs["mu"] = torch.cat([bufs["mu"], bufs["mu"][:1]])
    with pytest.raises((TypeError, ValueError)):
        rdk.RDState(**bufs)


# ---- instance level -------------------------------------------------------------


def _random_instance(rng, m=8, k_hi=4, size_hi=12, avail_hi=4, busy_hi=8):
    """The seeded generator of tests/test_rd_parity.py: small μ and tight
    busy ranges force dense tie-breaking."""
    k = int(rng.integers(1, k_hi + 1))
    groups = tuple(
        RefGroup(
            int(rng.integers(1, size_hi)),
            tuple(
                sorted(
                    rng.choice(
                        m, size=int(rng.integers(1, avail_hi + 1)), replace=False
                    ).tolist()
                )
            ),
        )
        for _ in range(k)
    )
    return RefProblem(
        busy=rng.integers(0, busy_hi, m), mu=rng.integers(1, 4, m), groups=groups
    )


def _twins():
    """The deterministic twins of tests/test_rd_parity.py."""
    P, G = RefProblem, RefGroup
    return {
        # deletion stops when a max-level server holds only sole copies
        "sole-copy": P(
            busy=np.array([9, 0, 0, 0]),
            mu=np.array([1, 1, 1, 1]),
            groups=(G(3, (0,)), G(6, (1, 2, 3))),
        ),
        # the deletion phase exits at once: the pure dedup walk
        "dedup-order": P(
            busy=np.array([5, 5, 5]),
            mu=np.array([2, 2, 2]),
            groups=(G(1, (0,)), G(4, (0, 1, 2)), G(2, (1, 2))),
        ),
        # identical server sets are distinct classes; strips end mid-class
        "duplicate-groups": P(
            busy=np.array([2, 2, 0, 0]),
            mu=np.array([3, 3, 3, 3]),
            groups=(G(7, (0, 1)), G(7, (0, 1)), G(11, (0, 2, 3))),
        ),
        "single-server": P(
            busy=np.array([1, 0]), mu=np.array([1, 2]), groups=(G(5, (0,)),)
        ),
        "single-task": P(
            busy=np.array([1, 0]), mu=np.array([1, 2]), groups=(G(1, (0, 1)),)
        ),
    }


def _seeded(n, seed=0, **kw):
    rng = np.random.default_rng(seed)
    return [_random_instance(rng, **kw) for _ in range(n)]


def _assert_same(got, want):
    assert got.alloc == want.alloc
    assert got.phi == want.phi


@pytest.fixture
def no_host_rerun(monkeypatch):
    """Make any host re-run fail: proves the device path produced the
    result (a silent overflow would hide a device bug)."""

    def _refuse(*args, **kwargs):
        raise AssertionError("device RD re-ran on the host unexpectedly")

    monkeypatch.setattr(rd_torch, "replica_deletion", _refuse)
    monkeypatch.setattr(rd_torch, "host_commit_walk", _refuse)


def _check_instance(ref_problem):
    want = replica_deletion_reference(ref_problem)
    _assert_same(rd_jax.replica_deletion_jax(ref_problem), want)
    problem = convert.from_reference_problem(ref_problem)
    _assert_same(rd_torch.replica_deletion_torch(problem), want)


def test_device_rd_matches_reference_on_seeded_instances(no_host_rerun):
    for ref_problem in _seeded(8):
        _check_instance(ref_problem)


@pytest.mark.parametrize("name", sorted(_twins()))
def test_device_rd_matches_reference_on_deterministic_twins(name, no_host_rerun):
    _check_instance(_twins()[name])


def test_device_rd_empty_problem_matches_host():
    ref_problem = RefProblem(busy=np.array([3, 1]), mu=np.array([1, 1]), groups=())
    want = ref_rd.replica_deletion(ref_problem)
    problem = convert.from_reference_problem(ref_problem)
    got = rd_torch.replica_deletion_torch(problem)
    assert got.alloc == want.alloc == []
    assert got.phi == want.phi


def test_device_rd_routes_through_the_strip_wrapper():
    problem = convert.from_reference_problem(_twins()["duplicate-groups"])
    rdk.reset_counts()
    rd_torch.replica_deletion_torch(problem)
    # the wrapper's CPU version ran: every iteration went through the wrapper
    assert rdk.COUNTS["rd_step"] == 0 and rdk.COUNTS["plain"] > 0
    assert rdk.COUNTS["wide"] == 0


@pytest.mark.parametrize("seed", range(3))
def test_port_host_rd_matches_reference_host_rd(seed):
    for ref_problem in _seeded(25, seed=seed, m=12, k_hi=6, size_hi=30, avail_hi=6):
        problem = convert.from_reference_problem(ref_problem)
        _assert_same(port_rd.replica_deletion(problem), ref_rd.replica_deletion(ref_problem))


# ---- overflow -------------------------------------------------------------------


def _crowded_groups(rng, m=10, k=120):
    """More classes than the kernel's narrowest block (128 slots) holds:
    120 groups, each on 6 of 10 servers."""
    return tuple(
        RefGroup(int(rng.integers(5, 20)), tuple(sorted(rng.choice(m, 6, replace=False).tolist())))
        for _ in range(k)
    )


def test_overflow_reruns_the_problem_on_the_host(monkeypatch):
    rng = np.random.default_rng(3)
    ref_problem = RefProblem(
        busy=rng.integers(0, 6, 10), mu=rng.integers(1, 4, 10), groups=_crowded_groups(rng)
    )
    monkeypatch.setattr(rd_torch, "rd_slot_capacity", lambda p: 128)
    rd_torch.reset_counts()
    got = rd_torch.replica_deletion_torch(convert.from_reference_problem(ref_problem))
    assert rd_torch.COUNTS["host_reruns"] == 1
    assert rd_torch.SLOT_PEAKS == []  # nothing solved on the device
    _assert_same(got, replica_deletion_reference(ref_problem))


def _burst(rng, m=10, n_jobs=3):
    base = rng.integers(0, 6, m)
    return [
        RefProblem(
            busy=base,
            mu=rng.integers(1, 4, m),
            groups=_random_instance(rng, m=m).groups,
        )
        for _ in range(n_jobs)
    ]


def test_overflow_reruns_the_burst_with_the_host_commit_walk(monkeypatch):
    rng = np.random.default_rng(5)
    burst = _burst(rng)
    burst[1] = RefProblem(busy=burst[1].busy, mu=burst[1].mu, groups=_crowded_groups(rng))
    problems = [convert.from_reference_problem(p) for p in burst]
    want = port_rd.host_commit_walk(problems)
    monkeypatch.setattr(rd_torch, "rd_slot_capacity", lambda p: 128)
    rd_torch.reset_counts()
    got = rd_torch.replica_deletion_torch_chain(problems)
    assert rd_torch.COUNTS["host_reruns"] == 1
    for g, w in zip(got, want):
        _assert_same(g, w)


def test_slot_reuse_keeps_a_job_on_the_device_that_the_reference_reruns(
    monkeypatch, no_host_rerun
):
    """One group of 300 tasks on 10 of 256 servers: the reference's bump
    allocator overflows its 1024 slots and re-runs the job on the host;
    the port, with the same capacity, keeps one live slot per class and
    stays on the device."""
    rng = np.random.default_rng(0)
    m = 256
    group = RefGroup(300, tuple(sorted(rng.choice(m, 10, replace=False).tolist())))
    ref_problem = RefProblem(
        busy=rng.integers(0, 3, m), mu=rng.integers(1, 3, m), groups=(group,)
    )
    reruns = []

    def host(problem):
        reruns.append(problem)
        return ref_rd.replica_deletion(problem)

    monkeypatch.setattr(rd_jax, "replica_deletion", host)
    want = rd_jax.replica_deletion_jax(ref_problem)
    assert len(reruns) == 1
    problem = convert.from_reference_problem(ref_problem)
    assert rd_torch.rd_slot_capacity(problem) == rd_jax.rd_slot_capacity(ref_problem)
    rd_torch.reset_counts()
    _assert_same(rd_torch.replica_deletion_torch(problem), want)
    ((capacity, peak),) = rd_torch.SLOT_PEAKS
    assert capacity == 1024 and peak < capacity


def test_slot_capacity_is_the_references_rule_capped_at_the_kernel():
    for ref_problem in _seeded(20, seed=4, m=64, k_hi=8, size_hi=400, avail_hi=12):
        problem = convert.from_reference_problem(ref_problem)
        assert rd_torch.rd_slot_capacity(problem) == rd_jax.rd_slot_capacity(ref_problem)
    # 32·K·A + 256 past the lane ceiling: the reference routes to jnp,
    # the port caps C (and re-runs on the host if that overflows)
    m = 64
    wide = RefProblem(
        busy=np.zeros(m, np.int64),
        mu=np.ones(m, np.int64),
        groups=tuple(RefGroup(50, tuple(range(k % 8, k % 8 + 40))) for k in range(16)),
    )
    assert rd_jax.rd_slot_capacity(wide) > rdk.RD_MAX_C
    assert rd_torch.rd_slot_capacity(convert.from_reference_problem(wide)) == rdk.RD_MAX_C


def _live_classes(st):
    live = (st.size[:-1] > 0).numpy()
    rows = np.concatenate(
        [st.grp[:-1].numpy()[:, None], st.holders[:-1].numpy()], axis=1
    )[live]
    return rows


def test_a_class_holds_one_live_slot(monkeypatch, no_host_rerun):
    """After every iteration the live slots are distinct classes, and the
    recorded peak is the most live slots seen."""
    seen = []
    step = rdk.rd_step

    def checked(st, dedup):
        step(st, dedup)
        rows = _live_classes(st)
        assert len(np.unique(rows, axis=0)) == len(rows)
        seen.append(len(rows))

    monkeypatch.setattr(rdk, "rd_step", checked)
    rng = np.random.default_rng(8)
    for _ in range(4):
        ref_problem = _random_instance(rng, m=16, k_hi=5, size_hi=40, avail_hi=7)
        seen.clear()
        rd_torch.reset_counts()
        _assert_same(
            rd_torch.replica_deletion_torch(convert.from_reference_problem(ref_problem)),
            replica_deletion_reference(ref_problem),
        )
        ((capacity, peak),) = rd_torch.SLOT_PEAKS
        assert max(seen, default=0) <= peak <= capacity


def test_hash_collisions_leave_the_result_unchanged(monkeypatch, no_host_rerun):
    """With every server's hash word 0 a class's hash is its group's, so
    most searches find a slot of another class: the row check refuses
    it, the class opens a second live slot, and the assignment is the
    same."""
    monkeypatch.setattr(rd_torch, "_server_hash_words", lambda m: np.zeros(m + 1, np.int64))
    monkeypatch.setattr(rd_torch, "rd_slot_capacity", lambda p: 1024)
    rng = np.random.default_rng(9)
    for _ in range(4):
        ref_problem = _random_instance(rng, m=12, k_hi=3, size_hi=40, avail_hi=6)
        _assert_same(
            rd_torch.replica_deletion_torch(convert.from_reference_problem(ref_problem)),
            replica_deletion_reference(ref_problem),
        )


def test_no_overflow_means_no_host_rerun(no_host_rerun):
    rng = np.random.default_rng(3)
    ref_problem = _random_instance(rng, m=10, k_hi=4, size_hi=20, avail_hi=6)
    rd_torch.reset_counts()
    got = rd_torch.replica_deletion_torch(convert.from_reference_problem(ref_problem))
    _assert_same(got, replica_deletion_reference(ref_problem))
    problems = [convert.from_reference_problem(p) for p in _burst(rng)]
    rd_torch.replica_deletion_torch_chain(problems)
    assert rd_torch.COUNTS["host_reruns"] == 0


# ---- chain ----------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_chain_matches_sequential_admission_and_reference_chain(seed, no_host_rerun):
    """One chained pass ≡ per-arrival RD with eq. 2 commits between jobs,
    and ≡ the reference's ``replica_deletion_jax_chain``."""
    rng = np.random.default_rng(seed)
    ref_problems = _burst(rng, m=10, n_jobs=1 + seed)
    want = rd_jax.replica_deletion_jax_chain(ref_problems)
    problems = [convert.from_reference_problem(p) for p in ref_problems]
    got = rd_torch.replica_deletion_torch_chain(problems)
    busy = problems[0].busy.copy()
    for prob, g, w in zip(problems, got, want):
        seq = AssignmentProblem(busy=busy, mu=prob.mu, groups=prob.groups)
        host = port_rd.replica_deletion(seq)
        g.validate(seq)
        _assert_same(g, host)
        _assert_same(g, w)
        busy = commit_busy(busy, host, seq.mu, seq.n_servers)


# ---- rejections -----------------------------------------------------------------


def test_device_rd_rejects_an_oversized_cluster():
    m = port_rd.RD_DEVICE_MAX_M + 1
    problem = AssignmentProblem(
        busy=np.zeros(m, np.int64), mu=np.ones(m, np.int64), groups=(TaskGroup(1, (0, 1)),)
    )
    with pytest.raises(ValueError, match="at most"):
        rd_torch.replica_deletion_torch(problem)
    with pytest.raises(ValueError, match="at most"):
        rd_torch.replica_deletion_torch_chain([problem, problem])


def _wide_burst(width, m=80, n_jobs=2, seed=0):
    """A same-slot burst whose groups span ``width`` of ``m`` servers (and
    narrower ones beside them), with tight busy ranges and small μ; few
    tasks keep the slot capacity (and the CPU's sorts) at 128-256."""
    rng = np.random.default_rng(1000 + width + seed)
    base = rng.integers(0, 4, m)

    def group(w, hi):
        return RefGroup(int(rng.integers(1, hi)), tuple(sorted(rng.choice(m, w, replace=False).tolist())))

    def groups():
        return (group(width, 4), group(int(rng.integers(2, width + 1)), 3), group(3, 6))

    return [RefProblem(busy=base, mu=rng.integers(1, 4, m), groups=groups())
            for _ in range(n_jobs)]


@pytest.mark.parametrize("width", [32, 33, 48, 64])
def test_device_rd_matches_host_and_reference_at_group_width(width, no_host_rerun):
    """Groups of ``width`` available servers (past the reference kernel's
    24 key rows from 33 on): ``rd_torch`` on the CPU equals the host RD
    and ``rd_jax`` on its jnp route, for one problem and for a chain."""
    ref_burst = _wide_burst(width)
    want = rd_jax.replica_deletion_jax(ref_burst[0])  # the jnp strip route
    _assert_same(want, ref_rd.replica_deletion(ref_burst[0]))
    problems = [convert.from_reference_problem(p) for p in ref_burst]
    rdk.reset_counts()
    _assert_same(rd_torch.replica_deletion_torch(problems[0]), want)
    got = rd_torch.replica_deletion_torch_chain(problems)
    for g, w, h in zip(got, rd_jax.replica_deletion_jax_chain(ref_burst),
                       port_rd.host_commit_walk(problems)):
        _assert_same(g, w)
        _assert_same(g, h)
    assert rdk.COUNTS["plain"] > 0 and rdk.COUNTS["wide"] == 0


def test_chain_rejects_mismatched_bursts():
    g = (TaskGroup(2, (0, 1)),)
    p1 = AssignmentProblem(busy=np.array([0, 0]), mu=np.array([1, 1]), groups=g)
    p2 = AssignmentProblem(busy=np.array([1, 0]), mu=np.array([1, 1]), groups=g)
    p3 = AssignmentProblem(busy=np.zeros(3), mu=np.ones(3), groups=g)
    with pytest.raises(ValueError, match="same pre-burst busy"):
        rd_torch.replica_deletion_torch_chain([p1, p2])
    with pytest.raises(ValueError, match="single cluster size"):
        rd_torch.replica_deletion_torch_chain([p1, p3])
    assert rd_torch.replica_deletion_torch_chain([]) == []


# ---- engine ---------------------------------------------------------------------

SMALL = dict(n_jobs=6, total_tasks=200, n_servers=8, seed=11)


@pytest.mark.parametrize("ordering", ["fifo", "ocwf-acc"])
@pytest.mark.parametrize("scenario", ["bursty", "alibaba"])
def test_engine_rd_torch_matches_reference_rd_jnp(scenario, ordering):
    ref_jobs = ref_traces.generate(scenario, **SMALL)
    with ref_backend.set_backend(rd="jnp"):
        want = ref_runtime.SchedulingEngine(
            SMALL["n_servers"], ref_runtime.make_policy("rd", ordering)
        ).run(ref_jobs)
    jobs = convert.from_reference_jobs(ref_jobs)
    rdk.reset_counts()
    got = SchedulingEngine(
        SMALL["n_servers"],
        make_policy("rd_torch", ordering),
        debug=True,
        on_slot=lambda cluster, slot: cluster.assert_invariant(),
    ).run(jobs)
    assert got.jct == want.jct
    assert got.makespan == want.makespan
    assert got.failed_jobs == want.failed_jobs
    assert rdk.COUNTS["plain"] > 0  # the device path ran (its CPU version here)


@pytest.mark.parametrize("ordering", ["fifo", "setf"])
def test_engine_rd_torch_batched_equals_per_arrival_and_host_rd(ordering):
    jobs = generate("bursty", n_jobs=8, total_tasks=250, n_servers=12, seed=7)
    assert len({j.arrival for j in jobs}) < len(jobs), "trace must contain bursts"
    host = SchedulingEngine(12, make_policy("rd", ordering), debug=True).run(jobs)
    batched = SchedulingEngine(12, make_policy("rd_torch", ordering)).run(jobs)
    per_arrival = SchedulingEngine(
        12, make_policy("rd_torch", ordering), batch_arrivals=False
    ).run(jobs)
    for got in (batched, per_arrival):
        assert got.jct == host.jct
        assert got.makespan == host.makespan
    assert make_policy("rd_torch").batch_assigner is not None
    assert make_policy("rd").batch_assigner is None
