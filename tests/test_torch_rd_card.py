"""The CUDA RD step kernel against its plain iteration, on the card.

Needs a CUDA device (the kernel has no CPU mode), so it skips elsewhere;
run it on a GPU machine with
``python -m pytest -m gpu tests/test_torch_rd_card.py``.  It imports
only the port, so it runs where jax is not installed.

Each case drives device RD in lockstep: every iteration runs the kernel
on one copy of the state and ``rd_step_plain`` on another, and every
buffer (spare row and lane included) must be bit for bit equal after
each, through both loops and a few iterations past their exits.
``chip_smoke.py`` makes the same check on the main path's first job;
the last test here runs one job of that path's trace with more tasks
than the kernel's slot ceiling (about a minute).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import AssignmentProblem, TaskGroup, rd_torch
from repro_torch.core.rd import replica_deletion
from repro_torch.kernels import rd as rdk
from repro_torch.traces import generate

I32 = np.iinfo(np.int32)
CASES = (
    "random",
    "ties",
    "no-candidates",
    "quota-past-total",
    "int32-extremes",
    "free-slot-shortage",
    "width-33",
    "width-48",
    "width-64",
    "max-geometry",
)


def _groups(rng, m, k, width, size_hi):
    return tuple(
        TaskGroup(int(rng.integers(1, size_hi)),
                  tuple(sorted(rng.choice(m, int(rng.integers(1, width + 1)),
                                          replace=False).tolist())))
        for _ in range(k)
    )


def _case(name):
    """(problem, slot capacity or None) of one edge case, from a seed."""
    rng = np.random.default_rng(CASES.index(name))
    m = 64
    busy = rng.integers(0, 40, m)
    mu = rng.integers(1, 4, m)
    capacity = None
    if name == "random":
        groups = _groups(rng, m, 10, 12, 60)
    elif name == "ties":  # equal busy times, repeated server sets
        busy[:] = 0
        mu[:] = 2
        base = _groups(rng, m, 4, 6, 60)
        groups = base * 3
    elif name == "no-candidates":  # single-copy groups only
        groups = tuple(TaskGroup(int(rng.integers(1, 30)), (int(s),))
                       for s in rng.choice(m, 12, replace=False))
    elif name == "quota-past-total":  # quota = load_m, past the multi-copy members
        mu[:] = 1000
        groups = _groups(rng, m, 10, 8, 80) + tuple(
            TaskGroup(int(rng.integers(50, 90)), (int(s),)) for s in range(0, m, 3))
    elif name == "int32-extremes":  # busy_est wraps past INT32_MAX on some servers
        busy = np.where(rng.random(m) < 0.5, I32.max - rng.integers(0, 20, m),
                        rng.integers(0, 20, m))
        groups = _groups(rng, m, 10, 10, 120)
    elif name == "free-slot-shortage":  # 120 classes spawn past 128 slots
        groups = tuple(TaskGroup(int(rng.integers(5, 20)),
                                 tuple(sorted(rng.choice(10, 6, replace=False).tolist())))
                       for _ in range(120))
        capacity = rdk.MIN_LANES
    elif name.startswith("width-"):
        width = int(name.split("-")[1])
        groups = (TaskGroup(12, tuple(sorted(rng.choice(m, width, replace=False).tolist()))),
                  *_groups(rng, m, 5, width, 10))
    elif name == "max-geometry":  # the server and slot ceilings
        m = rdk.RD_MAX_M
        busy, mu = rng.integers(0, 40, m), rng.integers(1, 4, m)
        groups = _groups(rng, m, 6, 16, 40)
        capacity = rdk.RD_MAX_C
    return AssignmentProblem(busy=busy, mu=mu, groups=groups), capacity


def _lockstep(st, past_exit=2):
    """Run RD on ``st`` with the kernel, and the plain iteration on a
    clone, comparing every buffer after each iteration; returns the
    number of iterations."""
    shadow = st.clone()
    n = [0]

    def step(state, dedup):
        rdk.rd_step(state, dedup)
        rdk.rd_step_plain(shadow, dedup)
        torch.cuda.synchronize()
        for name, buf in state.buffers().items():
            if not torch.equal(buf, shadow.buffers()[name]):
                raise AssertionError(f"{name} differs after iteration {n[0]} (dedup={dedup})")
        n[0] += 1

    rd_torch.run_rd(st, step)
    for _ in range(past_exit):
        for dedup in (False, True):
            step(st, dedup)
    return n[0]


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_plain_on_the_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    problem, capacity = _case(case)
    st = rd_torch.initial_rd_state(problem, capacity=capacity)
    assert st.route == "kernel"
    rdk.reset_counts()
    n = _lockstep(st)
    assert rdk.COUNTS == {"rd_step": n, "plain": n, "wide": 0}
    if case == "free-slot-shortage":
        assert int(st.headroom) < 0
    elif case != "int32-extremes":
        assert int(st.headroom) >= 0


@pytest.mark.gpu
def test_kernel_matches_plain_where_prefix_sums_wrap():
    """Two classes of ~2^30 members on one server: the walk's int32 prefix
    sum wraps; a few iterations of each loop, in lockstep."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    m = 16
    groups = (TaskGroup(2**30 + 5, (1, 2, 3)), TaskGroup(2**30 + 7, (1, 2, 4)),
              TaskGroup(3, (1, 5)))
    problem = AssignmentProblem(busy=np.zeros(m, np.int64), mu=np.full(m, 7), groups=groups)
    st = rd_torch.initial_rd_state(problem, capacity=rdk.MIN_LANES)
    shadow = st.clone()
    for dedup in (False, True) * 3:
        rdk.rd_step(st, dedup)
        rdk.rd_step_plain(shadow, dedup)
        torch.cuda.synchronize()
        for name, buf in st.buffers().items():
            assert torch.equal(buf, shadow.buffers()[name]), (name, dedup)


@pytest.mark.gpu
def test_wrapper_routes_rows_past_the_ceiling_to_the_counted_plain_version():
    """Groups of 65+ servers: every iteration on the card takes the plain
    version by the counted rule (``wide``), none launches the kernel, and
    the assignment is the host RD's; the slot ceiling is refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(7)
    m = 160
    groups = (TaskGroup(6, tuple(sorted(rng.choice(m, 70, replace=False).tolist()))),
              TaskGroup(4, tuple(sorted(rng.choice(m, 9, replace=False).tolist()))))
    problem = AssignmentProblem(busy=rng.integers(0, 3, m), mu=rng.integers(1, 3, m),
                                groups=groups)
    rdk.reset_counts()
    got = rd_torch.replica_deletion_torch(problem)
    assert rdk.COUNTS["wide"] == rdk.COUNTS["plain"] > 0 and rdk.COUNTS["rd_step"] == 0
    want = replica_deletion(problem)
    assert got.alloc == want.alloc and got.phi == want.phi
    bufs = rd_torch.initial_rd_state(problem).buffers()
    for name in ("holders", "size", "cnt", "grp", "hash"):
        t = bufs[name]
        bufs[name] = t.new_zeros((2 * rdk.RD_MAX_C + 1, *t.shape[1:]))
    with pytest.raises(ValueError):
        rdk.RDState(**bufs)


@pytest.mark.gpu
def test_a_job_with_more_tasks_than_kernel_lanes_runs_on_the_card():
    """The first job of chip_smoke.py's 4096-server trace with more tasks
    than RD_MAX_C: its slot capacity stays within the kernel's slots, and
    every iteration launches the kernel, with no plain iteration and no
    host re-run, for the host RD's assignment."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    m = 4096
    jobs = generate("bursty", n_servers=m, n_jobs=1000, total_tasks=4_655_227, seed=0)
    job = next(
        j
        for j in sorted(jobs, key=lambda j: (j.arrival, j.job_id))
        if j.n_tasks > rdk.RD_MAX_C
    )
    problem = AssignmentProblem(busy=np.zeros(m, np.int64), mu=job.mu, groups=job.groups)
    rdk.reset_counts()
    rd_torch.reset_counts()
    got = rd_torch.replica_deletion_torch(problem)
    assert rdk.COUNTS["rd_step"] > 0 and rdk.COUNTS["plain"] == 0
    assert rd_torch.COUNTS["host_reruns"] == 0
    ((capacity, peak),) = rd_torch.SLOT_PEAKS
    assert capacity == rd_torch.rd_slot_capacity(problem) <= rdk.RD_MAX_C
    assert peak <= capacity
    want = replica_deletion(problem)
    assert got.alloc == want.alloc and got.phi == want.phi


@pytest.mark.gpu
def test_launch_config_matches_the_compiled_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.analysis.contracts import CONTRACTS

    static, max_threads = rdk.kernel_attributes()
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    problem, capacity = _case("random")
    st = rd_torch.initial_rd_state(problem, capacity=capacity)
    rdk.LAUNCH_CONFIGS.clear()
    rd_torch.run_rd(st)
    ((c, a, m), cfg), = rdk.LAUNCH_CONFIGS.items()
    assert (c, a, m) == (st.c_slots, st.row_ids, st.m_servers)
    assert cfg == CONTRACTS["rd.step"].smem({"c": c, "a": a, "m": m, "device": "cuda"})
    assert cfg.static_smem == static and cfg.threads == max_threads
    for c, m in ((rdk.RD_MAX_C, rdk.RD_MAX_M), (rdk.MIN_LANES, 1)):
        assert rdk.launch_config(c, m).smem_bytes <= optin - 1024  # the launcher's margin
