"""The port's locality-aware loader and checkpoint store against the
reference's.

- the loader: the reference's cases (locality, every shard once,
  deterministic batches unchanged by a failed host, epochs differ, total
  replica loss, locality on read) on both packages, the port's schedule
  and batches equal to the reference's, and the port's ``wf_torch`` as
  the assignment giving the host water-filling's schedule;
- the store: round trip with a bfloat16 leaf, a corrupted leaf detected,
  the manager's garbage collection and async save, a shape mismatch
  refused; and checkpoints crossing between the packages both ways
  (the same files, manifests and crc32s; bf16 values equal bit for bit).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as ref_restore
from repro.checkpoint import save_checkpoint as ref_save
from repro.data import LocalityAwareLoader as RefLoader
from repro.data import ShardStore as RefShardStore
from repro_torch.backend import set_backend
from repro_torch.checkpoint import (
    CheckpointManager,
    latest_step,
    read_manifest,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.core.wf_torch import water_filling_torch
from repro_torch.data import LocalityAwareLoader, ShardStore

STORE = dict(n_shards=64, n_hosts=8, replicas=3, tokens_per_shard=256, vocab=1000)
LOADER = dict(batch_tokens=1024, seq_len=64)


def _both():
    return ((ShardStore(**STORE), LocalityAwareLoader),
            (RefShardStore(**STORE), RefLoader))


def _batches(loader, epoch):
    return [np.asarray(b) for b in loader.batches(epoch)]


@pytest.mark.parametrize("package", ["port", "reference"])
def test_schedule_respects_locality(package):
    store, cls = _both()[package == "reference"]
    for host, shards in cls(store, **LOADER).schedule_epoch(0).items():
        for s in shards:
            assert host in store.placement[s]


@pytest.mark.parametrize("package", ["port", "reference"])
def test_every_shard_scheduled_once(package):
    store, cls = _both()[package == "reference"]
    sched = cls(store, **LOADER).schedule_epoch(0)
    assert sorted(s for shards in sched.values() for s in shards) == list(range(64))


@pytest.mark.parametrize("package", ["port", "reference"])
def test_batches_deterministic_and_failover_invariant(package):
    store, cls = _both()[package == "reference"]
    loader = cls(store, **LOADER)
    b1 = _batches(loader, 0)
    assert b1
    assert all((x == y).all() for x, y in zip(b1, _batches(loader, 0)))
    store.fail_host(2)
    assert all((x == y).all() for x, y in zip(b1, _batches(loader, 0)))


@pytest.mark.parametrize("package", ["port", "reference"])
def test_epochs_differ(package):
    store, cls = _both()[package == "reference"]
    loader = cls(store, **LOADER)
    assert not (_batches(loader, 0)[0] == _batches(loader, 1)[0]).all()


@pytest.mark.parametrize("package", ["port", "reference"])
def test_total_replica_loss_raises(package):
    store, _ = _both()[package == "reference"]
    for h in store.placement[0]:
        store.fail_host(h)
    with pytest.raises(IOError):
        store.live_placement(0)


@pytest.mark.parametrize("package", ["port", "reference"])
def test_locality_enforced_on_read(package):
    store, _ = _both()[package == "reference"]
    bad = next(h for h in range(store.n_hosts) if h not in store.placement[0])
    with pytest.raises(IOError):
        store.read(0, bad)


@pytest.mark.parametrize("epoch,failed", [(0, ()), (1, ()), (0, (2,)), (3, (1, 5))])
def test_schedule_and_batches_equal_the_reference(epoch, failed):
    """The same placement, schedule (shard -> host) and token batches;
    the port's batches are int32 tensors."""
    (store, cls), (ref_store, ref_cls) = _both()
    assert store.placement == ref_store.placement
    for h in failed:
        store.fail_host(h)
        ref_store.fail_host(h)
    loader, ref = cls(store, **LOADER), ref_cls(ref_store, **LOADER)
    assert loader.schedule_epoch(epoch) == ref.schedule_epoch(epoch)
    got, want = list(loader.batches(epoch)), list(ref.batches(epoch))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert isinstance(g, torch.Tensor) and g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w)


def test_wf_torch_schedules_the_epoch_as_the_host_water_filling():
    store = ShardStore(**STORE)
    with set_backend(device="cpu"):
        got = LocalityAwareLoader(store, assign=water_filling_torch, **LOADER).schedule_epoch(0)
    assert got == LocalityAwareLoader(store, **LOADER).schedule_epoch(0)


# ---- checkpoints ----------------------------------------------------------


def _tree():
    return {
        "a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "nested": {"b": torch.tensor([[1.5, -2.25], [3.0, 1e-3]], dtype=torch.bfloat16)},
        "step": torch.tensor(7, dtype=torch.int32),
    }


def _ref_tree():
    return {
        "a": jnp.arange(12, dtype=jnp.float32).reshape(3, 4),
        "nested": {"b": jnp.asarray([[1.5, -2.25], [3.0, 1e-3]], jnp.bfloat16)},
        "step": jnp.int32(7),
    }


def _leaves(tree):
    return [tree["a"], tree["nested"]["b"], tree["step"]]


def _bits(x) -> np.ndarray:
    """The bytes of a torch tensor or a jax/numpy array, as uint8."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy()
    return np.frombuffer(np.ascontiguousarray(np.asarray(x)).tobytes(), np.uint8)


def test_checkpoint_roundtrip(tmp_path):
    tree = _tree()
    save_checkpoint(str(tmp_path), 5, tree)
    assert latest_step(str(tmp_path)) == 5
    restored = restore_checkpoint(str(tmp_path), 5, tree)
    for a, b in zip(_leaves(tree), _leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    entry = read_manifest(str(tmp_path), 5)["leaves"][1]
    assert (entry["name"], entry["dtype"], entry["raw_bytes"]) == ("nested_b", "bfloat16", True)


@pytest.mark.parametrize("victim", [0, 1])
def test_checkpoint_detects_corruption(tmp_path, victim):
    """A changed byte in a float32 or a raw bfloat16 leaf fails its crc32."""
    path = save_checkpoint(str(tmp_path), 1, _tree())
    name = sorted(f for f in os.listdir(path) if f.endswith(".npy"))[victim]
    arr = np.load(os.path.join(path, name))
    bad = arr.copy()
    bad.flat[0] += 1
    np.save(os.path.join(path, name), bad)
    with pytest.raises(IOError, match="checksum"):
        restore_checkpoint(str(tmp_path), 1, _tree())


def test_manager_gc_and_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = _tree()
    for step in (1, 2, 3, 4):
        mgr.save_async(step, tree)
        mgr.wait()
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == [3, 4]
    step, restored = mgr.restore_latest(tree)
    assert step == 4 and all(torch.equal(a, b) for a, b in zip(_leaves(tree), _leaves(restored)))
    mgr.save(5, tree)
    assert latest_step(str(tmp_path)) == 5 and len(os.listdir(tmp_path)) == 2


def test_restore_shape_mismatch_raises(tmp_path):
    tree = _tree()
    save_checkpoint(str(tmp_path), 1, tree)
    wrong = dict(tree)
    wrong["a"] = torch.zeros(4, 4)
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(str(tmp_path), 1, wrong)
    with pytest.raises(ValueError, match="leaves"):
        restore_checkpoint(str(tmp_path), 1, {"a": tree["a"]})


def test_restore_puts_leaves_on_the_requested_device(tmp_path):
    save_checkpoint(str(tmp_path), 2, _tree())
    like = {"a": np.zeros((3, 4)), "nested": {"b": 0}, "step": 0}
    like["nested"]["b"] = np.zeros((2, 2))
    got = restore_checkpoint(str(tmp_path), 2, like, device="cpu")
    assert all(isinstance(x, torch.Tensor) and x.device.type == "cpu" for x in _leaves(got))
    assert got["nested"]["b"].dtype == torch.bfloat16


def test_a_port_checkpoint_is_read_by_the_reference(tmp_path):
    """The port writes; the reference restores: the same values (bf16 bit
    for bit) and the manifest the reference would have written."""
    save_checkpoint(str(tmp_path / "port"), 3, _tree())
    ref_save(str(tmp_path / "ref"), 3, _ref_tree())
    got = ref_restore(str(tmp_path / "port"), 3, _ref_tree())
    for a, b in zip(_leaves(_tree()), jax.tree.leaves(got)):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    port_manifest = json.loads((tmp_path / "port" / "step_00000003" / "manifest.json").read_text())
    ref_manifest = json.loads((tmp_path / "ref" / "step_00000003" / "manifest.json").read_text())
    assert port_manifest == ref_manifest


def test_a_reference_checkpoint_is_read_by_the_port(tmp_path):
    ref_save(str(tmp_path), 9, _ref_tree())
    got = restore_checkpoint(str(tmp_path), 9, _tree())
    for a, b in zip(jax.tree.leaves(_ref_tree()), _leaves(got)):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert got["nested"]["b"].dtype == torch.bfloat16
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 7
