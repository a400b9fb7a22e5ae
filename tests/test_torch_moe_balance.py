"""WF-balanced MoE expert-replica routing: the port's
``balance_expert_replicas`` ≡ the reference's, on the CPU.

``replica_placement`` draws from a ``torch.Generator`` and cannot
reproduce ``jax.random.permutation``, so the parity tests hand both
implementations the reference's placement.  First the reference's own
test (``tests/test_serve.py``: 16 experts, 8 devices, 3 replicas), then
DeepSeek-V3's routed experts on its 32-GPU prefill unit (256 experts, 32
devices, 2 replicas) over steps that carry the queue.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve.moe_balance import balance_expert_replicas as ref_balance
from repro.serve.moe_balance import replica_placement as ref_placement
from repro_torch.backend import set_backend
from repro_torch.serve import balance_expert_replicas, replica_placement


@pytest.fixture(autouse=True)
def _cpu():
    with set_backend(device="cpu"):
        yield


def _i32(a):
    return torch.from_numpy(np.asarray(a, dtype=np.int32).copy())


def _both(load, placement, queue, rate):
    want_alloc, want_phi = ref_balance(jnp.asarray(load, jnp.int32), placement,
                                       jnp.asarray(queue, jnp.int32),
                                       jnp.asarray(rate, jnp.int32))
    alloc, phi = balance_expert_replicas(_i32(load), _i32(placement), _i32(queue), _i32(rate))
    np.testing.assert_array_equal(alloc.numpy(), np.asarray(want_alloc))
    assert int(phi) == int(want_phi)
    return alloc.numpy(), int(phi)


def test_moe_balance_beats_static_and_conserves():
    placement = ref_placement(16, 8, 3, seed=0)
    rng = np.random.default_rng(0)
    load = rng.integers(0, 256, 16)
    alloc, _ = _both(load, placement, np.zeros(8), np.ones(8))
    assert (alloc.sum(axis=1) == load).all()  # conservation
    pl = np.asarray(placement)
    for e in range(16):
        assert set(np.flatnonzero(alloc[e])) <= set(pl[e].tolist())  # locality
    static = np.zeros(8, np.int64)
    for e in range(16):
        static[pl[e, 0]] += load[e]
    assert alloc.sum(axis=0).max() <= static.max()


@pytest.mark.parametrize("seed", [0, 1])
def test_deepseek_v3_routed_experts_over_carried_steps(seed):
    """256 experts, top-8 over 4 × 2048 tokens (65,536 token-slots a
    step), 32 identical devices (μ = 1: the time unit is one token's
    expert pass), 2 replicas each, Zipf loads.  The queue carries between
    steps and drains by a device's even share of a step (2,048 tokens).
    Tokens are conserved, and Φ never exceeds the static split's (each
    expert's load on its first replica)."""
    e, d, r, slots = 256, 32, 2, 4 * 2048 * 8
    placement = ref_placement(e, d, r, seed=seed)
    first = np.asarray(placement)[:, 0]
    rng = np.random.default_rng(seed)
    rate = np.ones(d, np.int64)
    queue = np.zeros(d, np.int64)
    weights = 1.0 / np.arange(1, e + 1) ** 1.1
    for _ in range(3):
        load = rng.multinomial(slots, rng.permutation(weights / weights.sum()))
        alloc, phi = _both(load, placement, queue, rate)
        assert alloc.sum() == slots and (alloc.sum(axis=1) == load).all()
        static = queue.copy()
        np.add.at(static, first, load)
        assert phi <= int(static.max())
        queue = np.maximum(queue + alloc.sum(axis=0) - slots // d, 0)


@pytest.mark.parametrize("seed", [2, 3])
def test_heterogeneous_rates_match_reference(seed):
    """Devices of two speeds (μ in {1, 2}) with carried queues."""
    placement = ref_placement(64, 16, 2, seed=seed)
    rng = np.random.default_rng(seed)
    rate = rng.integers(1, 3, 16)
    queue = rng.integers(0, 500, 16)
    load = rng.integers(0, 400, 64)
    alloc, _ = _both(load, placement, queue, rate)
    assert (alloc.sum(axis=1) == load).all()


def test_replica_placement_is_a_seeded_balanced_round_robin():
    gen = torch.Generator().manual_seed(0)
    p = replica_placement(256, 32, 2, generator=gen)
    assert p.shape == (256, 2) and p.dtype == torch.int64
    assert int(p.min()) >= 0 and int(p.max()) < 32
    assert torch.bincount(p.reshape(-1), minlength=32).tolist() == [16] * 32
    again = replica_placement(256, 32, 2, generator=torch.Generator().manual_seed(0))
    other = replica_placement(256, 32, 2, generator=torch.Generator().manual_seed(1))
    assert torch.equal(p, again) and not torch.equal(p, other)
    with pytest.raises(TypeError):
        replica_placement(16, 8, 3)  # the generator is explicit


def test_port_placement_balances_like_the_reference():
    load = np.random.default_rng(3).integers(0, 256, 16)
    port = replica_placement(16, 8, 3, generator=torch.Generator().manual_seed(0))
    alloc, phi = balance_expert_replicas(_i32(load), port, _i32(np.zeros(8)), _i32(np.ones(8)))
    want_alloc, want_phi = ref_balance(jnp.asarray(load, jnp.int32), jnp.asarray(port.numpy()),
                                       jnp.zeros(8, jnp.int32), jnp.ones(8, jnp.int32))
    np.testing.assert_array_equal(alloc.numpy(), np.asarray(want_alloc))
    assert int(phi) == int(want_phi)
