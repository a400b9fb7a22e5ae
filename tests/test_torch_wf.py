"""``repro_torch.core.wf_torch`` against ``repro.core.wf_jax`` on the CPU.

The group scan, the independent-problems batch and the eq. 2 burst chain
must give the reference's allocations, levels, Φ and evolved busy
vectors exactly (int32, tolerance 0), on both water-level routes, and
the host adapters must give the reference adapters' assignments.  The
port runs K and B unpadded; the reference pads both to powers of two.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import backend as ref_backend
from repro.core import AssignmentProblem, TaskGroup
from repro.core import wf_jax
from repro_torch import backend, convert
from repro_torch.core import commit_busy, water_filling
from repro_torch.core import wf_torch
from repro_torch.kernels import waterlevel as wl

ROUTES = ("cuda", "torch")

# jitted once per shape; inside a waterlevel="jnp" scope (and on the CPU
# anyway) the reference resolves to its jnp pipeline while tracing
_ref_groups = jax.jit(wf_jax.water_fill_groups)
_ref_batch = jax.jit(wf_jax.water_fill_batch)
_ref_chain = jax.jit(wf_jax.water_fill_chain)


@pytest.fixture(autouse=True, scope="module")
def _cpu_one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with backend.set_backend(device="cpu"):
        yield
    torch.set_num_threads(threads)


def _dense(rng, b, k, m, busy_hi=20):
    """(B, M) busy/mu, (B, K, M) masks, (B, K) demands; some groups have
    zero demand and an empty mask, as padded groups do."""
    busy = rng.integers(0, busy_hi, (b, m)).astype(np.int32)
    mu = rng.integers(1, 6, (b, m)).astype(np.int32)
    masks = rng.random((b, k, m)) < 0.4
    masks[..., 0] |= ~masks.any(axis=-1)  # every group keeps one server
    demands = rng.integers(1, 60, (b, k)).astype(np.int32)
    idle = rng.random((b, k)) < 0.2
    demands[idle] = 0
    masks[idle] = False
    return busy, mu, masks, demands


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _eq(got, want, name):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("k,m", [(1, 1), (3, 9), (5, 16), (4, 140)])
@pytest.mark.parametrize("seed", range(3))
def test_water_fill_groups_matches_wf_jax(seed, k, m, route):
    rng = np.random.default_rng(seed)
    busy, mu, masks, demands = (x[0] for x in _dense(rng, 1, k, m))
    with ref_backend.set_backend(waterlevel="jnp"):
        want = _ref_groups(*_j(busy, mu, masks, demands))
    got = wf_torch.water_fill_groups(*_t(busy, mu, masks, demands), impl=route)
    for name, g, w in zip(("alloc", "levels", "phi"), got, want):
        assert g.dtype == torch.int32
        _eq(g, w, name)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("b,k,m", [(1, 2, 8), (3, 4, 16), (5, 3, 130)])
@pytest.mark.parametrize("seed", range(3))
def test_water_fill_batch_matches_wf_jax(seed, b, k, m, route):
    rng = np.random.default_rng(100 + seed)
    arrays = _dense(rng, b, k, m)
    with ref_backend.set_backend(waterlevel="jnp"):
        want = _ref_batch(*_j(*arrays))
    wl.reset_counts()
    got = wf_torch.water_fill_batch(*_t(*arrays), impl=route)
    for name, g, w in zip(("alloc", "levels", "phi"), got, want):
        _eq(g, w, name)
    # one water-level call per group step over all B rows
    assert wl.COUNTS["plain"] == k


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("b,k,m", [(1, 1, 4), (2, 3, 12), (5, 4, 16), (3, 2, 129)])
@pytest.mark.parametrize("seed", range(3))
def test_water_fill_chain_matches_wf_jax(seed, b, k, m, route):
    rng = np.random.default_rng(200 + seed)
    busy, mu, masks, demands = _dense(rng, b, k, m)
    with ref_backend.set_backend(waterlevel="jnp"):
        want = _ref_chain(*_j(busy[0], mu, masks, demands))
    got = wf_torch.water_fill_chain(*_t(busy[0], mu, masks, demands), impl=route)
    for name, g, w in zip(("alloc", "phi", "busy_out"), got, want):
        assert g.dtype == torch.int32
        _eq(g, w, name)


@pytest.mark.parametrize("seed", range(4))
def test_unpadded_chain_equals_padded(seed):
    """The reference pads K and B to powers of two (demand 0, empty mask,
    μ = 1); the port leaves them out — the real rows are unchanged."""
    rng = np.random.default_rng(300 + seed)
    b, k, m = 3, 5, 20
    busy, mu, masks, demands = _dense(rng, b, k, m)
    kp, bp = wf_torch._pad_k(k), wf_torch._pad_k(b)
    mu_p = np.ones((bp, m), np.int32)
    mu_p[:b] = mu
    masks_p = np.zeros((bp, kp, m), bool)
    masks_p[:b, :k] = masks
    demands_p = np.zeros((bp, kp), np.int32)
    demands_p[:b, :k] = demands
    alloc, phi, busy_out = wf_torch.water_fill_chain(*_t(busy[0], mu, masks, demands))
    alloc_p, phi_p, busy_out_p = wf_torch.water_fill_chain(
        *_t(busy[0], mu_p, masks_p, demands_p)
    )
    assert torch.equal(alloc, alloc_p[:b, :k])
    assert not alloc_p[:b, k:].any() and not alloc_p[b:].any()
    assert torch.equal(phi, phi_p[:b])
    assert torch.equal(busy_out, busy_out_p)
    groups, levels, gphi = wf_torch.water_fill_groups(
        *_t(busy[0], mu[0], masks[0], demands[0])
    )
    groups_p, levels_p, gphi_p = wf_torch.water_fill_groups(
        *_t(busy[0], mu_p[0], masks_p[0], demands_p[0])
    )
    assert torch.equal(groups, groups_p[:k]) and torch.equal(levels, levels_p[:k])
    assert int(gphi) == int(gphi_p)


# ---- host adapters on the problems of tests/test_engine.py:311-377 ----------


def _ref_problem(rng, n_servers=16, max_groups=5, max_tasks=40, busy_hi=10):
    busy = rng.integers(0, busy_hi, n_servers)
    mu = rng.integers(3, 6, n_servers)
    k = int(rng.integers(1, max_groups))
    groups = tuple(
        TaskGroup(
            int(rng.integers(1, max_tasks)),
            tuple(
                sorted(
                    rng.choice(
                        n_servers, size=int(rng.integers(2, 8)), replace=False
                    ).tolist()
                )
            ),
        )
        for _ in range(k)
    )
    return AssignmentProblem(busy=busy, mu=mu, groups=groups)


def _same(got, want):
    assert got.alloc == want.alloc
    assert got.phi == want.phi


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("seed", range(25))
def test_adapter_matches_water_filling_jax(seed, route):
    rng = np.random.default_rng(seed)
    ref = _ref_problem(rng)
    prob = convert.from_reference_problem(ref)
    got = wf_torch.water_filling_torch(prob, impl=route)
    _same(got, wf_jax.water_filling_jax(ref))
    _same(got, water_filling(prob))


@pytest.mark.parametrize("route", ROUTES)
def test_batch_adapter_matches_water_filling_jax_batch(route):
    rng = np.random.default_rng(0)
    refs = [_ref_problem(rng) for _ in range(12)]
    got = wf_torch.water_filling_torch_batch(
        [convert.from_reference_problem(p) for p in refs], impl=route
    )
    for g, w in zip(got, wf_jax.water_filling_jax_batch(refs)):
        _same(g, w)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("seed,n_jobs", [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 8)])
def test_chain_adapter_matches_water_filling_jax_chain(seed, n_jobs, route):
    rng = np.random.default_rng(seed)
    base = _ref_problem(rng, n_servers=12, max_groups=4, max_tasks=30)
    refs = [
        AssignmentProblem(busy=base.busy, mu=p.mu, groups=p.groups)
        for p in (
            _ref_problem(rng, n_servers=12, max_groups=4, max_tasks=30)
            for _ in range(n_jobs)
        )
    ]
    probs = [convert.from_reference_problem(p) for p in refs]
    got = wf_torch.water_filling_torch_chain(probs, impl=route)
    for g, w in zip(got, wf_jax.water_filling_jax_chain(refs)):
        _same(g, w)
    # ≡ sequential host WF with eq. 2 commits between jobs
    busy = probs[0].busy.copy()
    for prob, g in zip(probs, got):
        seq = type(prob)(busy=busy, mu=prob.mu, groups=prob.groups)
        _same(g, water_filling(seq))
        busy = commit_busy(busy, g, seq.mu, 12)


def test_empty_inputs():
    empty = convert.from_reference_problem(
        AssignmentProblem(busy=np.zeros(3), mu=np.ones(3), groups=())
    )
    got = wf_torch.water_filling_torch(empty)
    assert got.alloc == [] and got.phi == 0
    assert wf_torch.water_filling_torch_batch([]) == []
    assert wf_torch.water_filling_torch_chain([]) == []


# ---- guards -----------------------------------------------------------------


def test_check_group_capacity_guards_degenerate_groups():
    mu = np.array([2, 3, 4], dtype=np.int32)
    masks = np.zeros((1, 2, 3), dtype=bool)
    masks[0, 0, 1] = True
    demands = np.array([[5, 0]], dtype=np.int32)
    wf_torch.check_group_capacity(mu, masks, demands)  # feasible: no raise
    with pytest.raises(ValueError, match="all-False"):
        wf_torch.check_group_capacity(mu, np.zeros((1, 2, 3), dtype=bool), demands)
    with pytest.raises(ValueError, match="zero total capacity"):
        wf_torch.check_group_capacity(np.zeros(3, np.int32), masks, demands)
    # AssignmentProblem can't express μ=0, but raw callers can — the
    # adapter must reject them before any device work
    from repro_torch.core import TaskGroup as PortGroup

    fake = types.SimpleNamespace(
        busy=np.zeros(3, dtype=np.int64),
        mu=np.zeros(3, dtype=np.int64),
        groups=(PortGroup(4, (0, 1)),),
        n_servers=3,
    )
    with pytest.raises(ValueError, match="zero total capacity"):
        wf_torch.water_filling_torch(fake)


def test_adapters_reject_mixed_cluster_sizes_and_busy_vectors():
    rng = np.random.default_rng(3)
    p12 = convert.from_reference_problem(_ref_problem(rng, n_servers=12))
    p16 = convert.from_reference_problem(_ref_problem(rng, n_servers=16))
    with pytest.raises(ValueError, match="single cluster size"):
        wf_torch.water_filling_torch_batch([p12, p16])
    with pytest.raises(ValueError, match="single cluster size"):
        wf_torch.water_filling_torch_chain([p12, p16])
    other = type(p12)(busy=p12.busy + 1, mu=p12.mu, groups=p12.groups)
    with pytest.raises(ValueError, match="same pre-burst busy vector"):
        wf_torch.water_filling_torch_chain([p12, other])
    no_groups = type(p12)(busy=p12.busy, mu=p12.mu, groups=())
    with pytest.raises(ValueError, match="non-empty problems"):
        wf_torch.water_filling_torch_chain([p12, no_groups])
