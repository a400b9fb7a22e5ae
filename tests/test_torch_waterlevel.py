"""The port's water-level kernel module against the reference's kernel.

The chain of evidence for the CUDA kernel: on the card, ``chip_smoke.py``
holds the kernel bit for bit against ``waterlevel_sorted_plain``; here,
on the CPU, ``waterlevel_sorted_plain`` is held against the TPU kernel's
own code (``repro.kernels.waterlevel._waterlevel_call_padded{,_batch}``
in interpret mode) on identical padded inputs.  Everything is int32, so
every comparison is exact (tolerance 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import backend as ref_backend
from repro.core import wf_jax
from repro.kernels.waterlevel import (
    _waterlevel_call_padded,
    _waterlevel_call_padded_batch,
)
from repro_torch import backend
from repro_torch.core import wf_torch
from repro_torch.kernels import waterlevel as wl

BIG = 2**30
CASES = ("random", "ties", "masked", "demand0")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rows(rng, m, bsz, case):
    """Pre-masked (B, m) busy/μ rows plus demands; every row keeps one
    available lane with positive capacity (the adapters' guard)."""
    busy = rng.integers(0, 25, (bsz, m))
    mu = rng.integers(0, 6, (bsz, m))
    mask = rng.random((bsz, m)) < 0.6
    demand = rng.integers(0, 12 * m + 50, bsz)
    rows = np.arange(bsz)
    if case == "ties":
        busy = rng.integers(0, 3, (bsz, m))
    elif case == "masked":  # all masked out but one lane
        mask[:] = False
        mask[rows, rng.integers(0, m, bsz)] = True
    elif case == "demand0":
        demand[:] = 0
    elif case == "boundary":  # busy just under the BIG sentinel
        busy[:, 0] = BIG - rng.integers(1, 1000, bsz)
        mu[:] = 1
        mask[:] = True
        demand = rng.integers(0, 50, bsz)
    dead = ~(mask & (mu > 0)).any(axis=1)
    pick = rng.integers(0, m, bsz)
    mask[rows[dead], pick[dead]] = True
    mu[rows[dead], pick[dead]] = np.maximum(1, mu[rows[dead], pick[dead]])
    return busy.astype(np.int32), mu.astype(np.int32), mask, demand.astype(np.int32)


def _padded(busy, mu, mask):
    bsz, m = busy.shape
    n = wl.n_lanes_for(m)
    b = np.full((bsz, n), BIG, np.int32)
    w = np.zeros((bsz, n), np.int32)
    b[:, :m] = np.where(mask, busy, BIG)
    w[:, :m] = np.where(mask, mu, 0)
    return b, w


def _reference(b, w, demand):
    if b.shape[0] == 1:
        out = _waterlevel_call_padded(
            jnp.asarray(b), jnp.asarray(w), jnp.asarray(demand.reshape(1, 1)),
            interpret=True,
        )
        level, take, idx = (np.asarray(x) for x in out)
        return level.reshape(1), take[None], idx[None]
    out = _waterlevel_call_padded_batch(
        jnp.asarray(b), jnp.asarray(w), jnp.asarray(demand.reshape(-1, 1)),
        interpret=True,
    )
    return tuple(np.asarray(x) for x in out)


def _assert_plain_matches_reference(busy, mu, mask, demand):
    b, w = _padded(busy, mu, mask)
    want = _reference(b, w, demand)
    got = wl.waterlevel_sorted_plain(
        torch.from_numpy(b), torch.from_numpy(w), torch.from_numpy(demand)
    )
    for name, g, r in zip(("level", "take_sorted", "idx_sorted"), got, want):
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), r, err_msg=name)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("bsz", [1, 3])
@pytest.mark.parametrize("m", [1, 3, 100, 128, 129, 300])
def test_plain_matches_reference_kernel(m, bsz, case):
    rng = np.random.default_rng(1000 * m + 10 * bsz + CASES.index(case))
    _assert_plain_matches_reference(*_rows(rng, m, bsz, case))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("bsz", [1, 3])
@pytest.mark.parametrize("m", [1, 2, 3])
def test_plain_matches_reference_kernel_int32_boundary(m, bsz, seed):
    """Busy levels just under BIG (the case of
    tests/test_waterlevel_parity.py::test_int32_boundary_busy_parity)."""
    rng = np.random.default_rng(seed)
    _assert_plain_matches_reference(*_rows(rng, m, bsz, "boundary"))


def test_wrapper_takes_plain_version_on_cpu():
    rng = np.random.default_rng(7)
    b, w = _padded(*_rows(rng, 40, 2, "random")[:3])
    d = torch.tensor([30, 0], dtype=torch.int32)
    wl.reset_counts()
    got = wl.waterlevel_sorted(torch.from_numpy(b), torch.from_numpy(w), d)
    assert wl.COUNTS == {
        "waterlevel": 0, "waterlevel_batch": 0, "wf_groups": 0, "wf_chain": 0,
        "wf_group_steps": 0, "plain": 1,
    }
    want = wl.waterlevel_sorted_plain(torch.from_numpy(b), torch.from_numpy(w), d)
    for g, p in zip(got, want):
        assert torch.equal(g, p)


@pytest.mark.parametrize(
    "bad",
    ["dtype", "ndim", "width", "pow2", "demand_shape", "noncontiguous"],
)
def test_wrapper_rejects_inputs_outside_the_contract(bad):
    b = torch.full((2, 128), BIG, dtype=torch.int32)
    w = torch.zeros((2, 128), dtype=torch.int32)
    d = torch.zeros(2, dtype=torch.int32)
    if bad == "dtype":
        b = b.long()
    elif bad == "ndim":
        b, w = b[0], w[0]
    elif bad == "width":
        b = torch.full((2, 64), BIG, dtype=torch.int32)
        w = torch.zeros((2, 64), dtype=torch.int32)
    elif bad == "pow2":
        b = torch.full((2, 192), BIG, dtype=torch.int32)
        w = torch.zeros((2, 192), dtype=torch.int32)
    elif bad == "demand_shape":
        d = torch.zeros(3, dtype=torch.int32)
    elif bad == "noncontiguous":
        b = torch.full((128, 2), BIG, dtype=torch.int32).t()
    with pytest.raises((TypeError, ValueError)):
        wl.waterlevel_sorted(b, w, d)


def test_resolve_precedence_and_ceiling():
    assert wl.resolve_waterlevel(None, 100) == "cuda"  # auto → the wrapper
    assert wl.resolve_waterlevel("torch", 100) == "torch"
    with backend.set_backend(waterlevel="torch"):
        assert wl.resolve_waterlevel(None, 100) == "torch"
        assert wl.resolve_waterlevel("cuda", 100) == "cuda"  # explicit wins
        with backend.set_backend(waterlevel="cuda"):
            assert wl.resolve_waterlevel(None, 100) == "cuda"
        assert wl.resolve_waterlevel(None, 100) == "torch"
    assert wl.resolve_waterlevel("cuda", wl.MAX_LANES) == "cuda"
    # past the kernel's ceiling the plain route runs whatever was asked
    assert wl.resolve_waterlevel("cuda", wl.MAX_LANES + 1) == "torch"
    with pytest.raises(ValueError):
        wl.resolve_waterlevel("pallas", 10)
    with pytest.raises(KeyError):
        with backend.set_backend(rd="host"):
            pass
    with pytest.raises(ValueError):
        with backend.set_backend(waterlevel="jnp"):
            pass


def test_device_scope_nests_and_defaults_to_cuda():
    assert backend.device() == torch.device("cuda")
    with backend.set_backend(device="cpu"):
        assert backend.device() == torch.device("cpu")
        with backend.set_backend(waterlevel="torch"):
            assert backend.device() == torch.device("cpu")
    assert backend.device() == torch.device("cuda")


def _single_instance(rng, m, case):
    busy, mu, mask, demand = _rows(rng, m, 1, case)
    return busy[0], mu[0], mask[0], int(demand[0])


@pytest.mark.parametrize("impl", ["cuda", "torch"])
@pytest.mark.parametrize("case", CASES + ("boundary",))
@pytest.mark.parametrize("m", [1, 2, 7, 24, 130])
def test_water_fill_alloc_and_level_match_wf_jax(m, case, impl):
    """The port's water_fill_alloc / water_level on both routes equal
    wf_jax's jnp path on the same instance."""
    rng = np.random.default_rng(31 * m + len(case))
    for _ in range(3):
        busy, mu, mask, demand = _single_instance(rng, m, case)
        with ref_backend.set_backend(waterlevel="jnp"):
            ref_alloc, ref_xi = wf_jax.water_fill_alloc(
                jnp.asarray(busy), jnp.asarray(mu), jnp.asarray(mask), jnp.int32(demand)
            )
            ref_level = wf_jax.water_level(
                jnp.asarray(busy), jnp.asarray(mu), jnp.asarray(mask), jnp.int32(demand)
            )
        args = (
            torch.from_numpy(busy),
            torch.from_numpy(mu),
            torch.from_numpy(mask),
            torch.tensor(demand, dtype=torch.int32),
        )
        alloc, xi = wf_torch.water_fill_alloc(*args, impl=impl)
        level = wf_torch.water_level(*args, impl=impl)
        assert alloc.dtype == torch.int32 and xi.dtype == torch.int32
        np.testing.assert_array_equal(alloc.numpy(), np.asarray(ref_alloc))
        assert int(xi) == int(ref_xi) == int(level) == int(ref_level)
