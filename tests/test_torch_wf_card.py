"""The fused water-filling kernel and the redesigned K1/K2 against their
plain versions, on the card, bit for bit.

Needs a CUDA device (the kernels have no CPU mode), so it skips
elsewhere; run it on a GPU machine with
``python -m pytest -m gpu tests/test_torch_wf_card.py``.  It imports only
the port, so it runs where jax is not installed.  ``chip_smoke.py`` makes
the same checks.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import waterlevel as wl

BIG = wl.BIG
LIVE = {"live-1": (1, 1), "live-8-12": (8, 12), "live-40-64": (40, 64),
        "live-200": (200, 200), "live-4096": (4096, 4096)}
CASES = (*LIVE, "ties", "demand0", "one-available", "boundary", "at-big", "reach-big")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def fused_inputs(rng, case, b, k, m, chain):
    """busy ((M,) in chain mode, else (B, M)), μ (B, M), masks (B, K, M),
    demands (B, K) for one case; every group with demand > 0 keeps a live
    lane with positive capacity."""
    lo, hi = LIVE.get(case, (8, 12))
    if case == "one-available":
        lo = hi = 1
    busy = rng.integers(0, 3 if case == "ties" else 200, (b, m)).astype(np.int64)
    mu = rng.integers(1, 6, (b, m))
    demands = rng.integers(1, 400, (b, k))
    if case == "demand0":
        demands[:] = 0
    elif case == "boundary":  # busy just under BIG
        busy = BIG - rng.integers(1, 1000, (b, m))
        mu[:] = 1
        demands = rng.integers(1, 50, (b, k))
    elif case == "at-big":  # available lanes at exactly BIG, with capacity
        busy[rng.random((b, m)) < 0.3] = BIG
    elif case == "reach-big":  # eq. 10 lifts levels to and past BIG
        busy = BIG - rng.integers(1, 4, (b, m))
        demands = rng.integers(200, 2000, (b, k))
    masks = np.zeros((b, k, m), bool)
    for i in range(b):
        for g in range(k):
            size = int(rng.integers(min(lo, m), min(hi, m) + 1))
            masks[i, g, rng.choice(m, size, replace=False)] = True
    busy = busy[0] if chain else busy
    dev = torch.device("cuda")
    return (torch.from_numpy(busy.astype(np.int32)).to(dev),
            torch.from_numpy(mu.astype(np.int32)).to(dev),
            torch.from_numpy(masks).to(dev),
            torch.from_numpy(demands.astype(np.int32)).to(dev))


@pytest.mark.gpu
@pytest.mark.parametrize("chain", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_fused_kernel_matches_the_plain_loop(card, case, chain):
    rng = np.random.default_rng(CASES.index(case) + 100 * chain)
    for m in (2, 4096, 32768):
        for k in (1, 8):
            for b in (1, 8):
                args = fused_inputs(rng, case, b, k, m, chain)
                wl.reset_counts()
                got = (wl.wf_chain if chain else wl.wf_groups)(*args)
                assert wl.COUNTS["plain"] == 0
                assert wl.COUNTS["wf_chain" if chain else "wf_groups"] == 1
                assert wl.COUNTS["wf_group_steps"] == b * k
                want = (wl.wf_chain_plain if chain else wl.wf_groups_plain)(*args)
                for g, p in zip(got, want):
                    assert torch.equal(g, p), (case, chain, m, k, b)


def _rows(rng, m, bsz, live):
    """Pre-masked padded rows with ``live`` lanes below BIG, some at BIG
    with capacity and some above it."""
    n = wl.n_lanes_for(m)
    b = np.full((bsz, n), BIG, np.int64)
    w = np.zeros((bsz, n), np.int64)
    for r in range(bsz):
        lanes = rng.choice(m, min(live, m), replace=False)
        b[r, lanes] = rng.integers(0, 200, len(lanes))
        w[r, lanes] = rng.integers(1, 6, len(lanes))
        extra = rng.choice(m, min(3, m), replace=False)
        b[r, extra] = BIG + rng.integers(0, 3, len(extra))
        w[r, extra] = 1
    d = rng.integers(0, 5000, bsz)
    return [torch.from_numpy(x.astype(np.int32)).cuda() for x in (b, w, d)]


@pytest.mark.gpu
@pytest.mark.parametrize("live", [1, 10, 33, 64, 200, 4096])
def test_standalone_kernel_sorts_only_the_live_lanes(card, live):
    rng = np.random.default_rng(live)
    for m in (2, 4096, 32768):
        for bsz in (1, 8):
            args = _rows(rng, m, bsz, live)
            wl.reset_counts()
            got = wl.waterlevel_sorted(*args)
            assert wl.COUNTS["plain"] == 0
            want = wl.waterlevel_sorted_plain(*args)
            for g, p in zip(got, want):
                assert torch.equal(g, p), (live, m, bsz)


# ---- the launch configuration, observability and MoE routing on the card ----


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [False, True])
def test_launch_config_matches_the_compiled_kernels(card, fused):
    """Every lane class: the contracts' static shared memory is the
    compiled variant's, the threads fit it, and the block fits the card's
    opt-in shared memory."""
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    n = wl.LANES
    while n <= wl.MAX_LANES:
        cfg = wl.launch_config(n, fused)
        static, max_threads = wl.kernel_attributes(fused, n)
        assert static == cfg.static_smem
        assert cfg.threads <= max_threads
        assert cfg.smem_bytes <= optin
        n *= 2


@pytest.mark.gpu
def test_launches_record_the_contracts_block(card):
    from repro_torch.analysis.contracts import CONTRACTS
    from repro_torch.core import wf_torch  # noqa: F401  (registers the wf_torch contracts)

    rng = np.random.default_rng(7)
    wl.LAUNCH_CONFIGS.clear()
    for m in (100, 4096, 16384):
        wl.wf_groups(*fused_inputs(rng, "random", 2, 3, m, chain=False))
        wl.waterlevel_sorted(*_rows(rng, m, 1, 10))
    assert len(wl.LAUNCH_CONFIGS) == 6
    for (kernel, n), cfg in wl.LAUNCH_CONFIGS.items():
        name = "wf_torch.groups" if kernel == "wf_fused" else "waterlevel.kernel"
        assert CONTRACTS[name].smem({"m": n, "k": 3, "requested": "cuda"}) == cfg


@pytest.mark.gpu
def test_profiler_counts_equal_fused_launches(card):
    from repro_torch import obs
    from repro_torch.backend import set_backend
    from repro_torch.core import AssignmentProblem, TaskGroup
    from repro_torch.core import wf_torch

    rng = np.random.default_rng(3)
    problems = [
        AssignmentProblem(
            busy=rng.integers(0, 50, 64), mu=rng.integers(1, 4, 64),
            groups=tuple(TaskGroup(int(rng.integers(1, 90)),
                                   tuple(sorted(rng.choice(64, 6, replace=False).tolist())))
                         for _ in range(int(rng.integers(1, 5)))),
        )
        for _ in range(12)
    ]
    with set_backend(device="cuda"):
        want = [wf_torch.water_filling_torch(p) for p in problems]
        wl.reset_counts()
        with obs.observe() as s:
            got = [wf_torch.water_filling_torch(p) for p in problems]
    assert [(a.alloc, a.phi) for a in got] == [(a.alloc, a.phi) for a in want]
    m = s.metrics
    assert m.counter("device.wf-groups.calls") == wl.COUNTS["wf_groups"] == 12
    assert m.counter("device.wf-groups.compiles") == len(
        {len(p.groups) for p in problems})  # one variant a K
    assert wl.COUNTS["plain"] == 0


@pytest.mark.gpu
def test_moe_balance_is_one_fused_launch_equal_to_the_plain_loop(card):
    from repro_torch.serve import balance_expert_replicas, replica_placement

    gen = torch.Generator().manual_seed(0)
    placement = replica_placement(256, 32, 2, generator=gen)
    rng = np.random.default_rng(0)
    load = torch.from_numpy(rng.multinomial(65_536, np.full(256, 1 / 256)).astype(np.int32))
    queue = torch.from_numpy(rng.integers(0, 3000, 32).astype(np.int32))
    rate = torch.ones(32, dtype=torch.int32)
    wl.reset_counts()
    alloc, phi = balance_expert_replicas(load.cuda(), placement, queue.cuda(), rate)
    assert wl.COUNTS["wf_groups"] == 1 and wl.COUNTS["plain"] == 0
    want_alloc, want_phi = balance_expert_replicas(load, placement, queue, rate)
    assert torch.equal(alloc.cpu(), want_alloc) and int(phi) == int(want_phi)
    assert int(alloc.sum()) == 65_536
