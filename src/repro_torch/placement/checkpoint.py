"""Checkpoint-manifest-derived placement: serve-layer blocks from disk truth.

The port's copy of ``repro/placement/checkpoint.py``.  The checkpoint
store (:mod:`repro_torch.checkpoint.store`) writes a JSON
manifest per step (tree structure, shapes, dtypes, crc32s).  This module
turns those manifests into placement state, so the serve layer's
eligible-replica sets come from *actual* model/LoRA placement instead of
caller-supplied tuples:

- :func:`register_checkpoint` validates a checkpoint directory's latest
  (or given) step manifest and registers a ``model/<name>`` or
  ``lora/<name>`` block whose replicas are the servers holding a
  restored copy;
- :func:`scan_checkpoints` walks a root of checkpoint directories and
  summarizes each as a :class:`CheckpointInfo`;
- :class:`CheckpointManifestPolicy` (registered as ``"checkpoint"``)
  keeps every manifest-backed block at a target replica count, topping
  up onto the least-loaded active servers after evictions or server
  leaves — checkpoint-driven re-replication.

The manifests are the reference's layout, so a checkpoint written by
either package registers here.
"""

from __future__ import annotations

import dataclasses
import os

from ..checkpoint.store import latest_step, read_manifest
from .policies import REPLICATION_POLICIES, _least_loaded
from .store import PlacementDelta, PlacementStore, lora_block, model_block

__all__ = [
    "CheckpointInfo",
    "scan_checkpoints",
    "register_checkpoint",
    "CheckpointManifestPolicy",
]

_SERVE_PREFIXES = ("model/", "lora/")


@dataclasses.dataclass(frozen=True)
class CheckpointInfo:
    """Validated summary of one checkpoint directory's latest step."""

    block: str
    directory: str
    step: int
    n_leaves: int
    n_params: int  # total elements across leaves (from manifest shapes)


def _summarize(block: str, directory: str, step: int) -> CheckpointInfo:
    manifest = read_manifest(directory, step)
    n_params = 0
    for leaf in manifest["leaves"]:
        count = 1
        for dim in leaf["shape"]:
            count *= int(dim)
        n_params += count
    return CheckpointInfo(
        block=block,
        directory=directory,
        step=int(manifest["step"]),
        n_leaves=len(manifest["leaves"]),
        n_params=n_params,
    )


def _latest_step(directory: str) -> int:
    step = latest_step(directory)
    if step is None:
        raise FileNotFoundError(
            f"no checkpoint steps under {directory!r} (expected step_<N>/ "
            "directories written by a checkpoint store)"
        )
    return step


def scan_checkpoints(root: str, *, kind: str = "model") -> list[CheckpointInfo]:
    """Summarize every checkpoint directory directly under ``root``.

    Each subdirectory containing at least one ``step_<N>`` checkpoint
    becomes a ``<kind>/<subdir-name>`` block candidate; directories
    without valid steps are skipped (not an error — the root may mix
    checkpoints with unrelated files).
    """
    out: list[CheckpointInfo] = []
    if not os.path.isdir(root):
        return out
    for name in sorted(os.listdir(root)):
        directory = os.path.join(root, name)
        if not os.path.isdir(directory):
            continue
        step = latest_step(directory)
        if step is None:
            continue
        out.append(_summarize(f"{kind}/{name}", directory, step))
    return out


def register_checkpoint(
    store: PlacementStore,
    directory: str,
    servers,
    *,
    name: str | None = None,
    kind: str = "model",
    step: int | None = None,
) -> CheckpointInfo:
    """Register a checkpoint's block with the servers holding a copy.

    Validates the manifest first (missing directory/step or a malformed
    manifest raises before any placement state changes), then registers
    ``model/<name>`` (or ``lora/<name>``) with ``servers`` as replicas.
    ``name`` defaults to the checkpoint directory's basename.
    """
    if kind == "model":
        block = model_block(name or os.path.basename(os.path.normpath(directory)))
    elif kind == "lora":
        block = lora_block(name or os.path.basename(os.path.normpath(directory)))
    else:
        raise ValueError(f"kind must be 'model' or 'lora', got {kind!r}")
    step = _latest_step(directory) if step is None else step
    info = _summarize(block, directory, step)
    store.add_block(block, servers)
    return info


@dataclasses.dataclass(frozen=True)
class CheckpointManifestPolicy:
    """Keep manifest-backed serve blocks at a target replica count.

    Rebalance proposes one replica add at a time per under-replicated
    ``model/``/``lora/`` block, onto the least-loaded active server not
    already holding it — so serve-layer eligible sets recover from
    evictions and server leaves without touching data blocks (those
    belong to the trace/data policies).  Deterministic: blocks in name
    order, ties by server id; the rng is unused.
    """

    name: str = "checkpoint"
    replicas: int = 2

    def rebalance(self, store, rng) -> PlacementDelta:
        load = store.server_load()
        added: list[tuple[str, int]] = []
        for block in store.blocks():
            if not block.startswith(_SERVE_PREFIXES):
                continue
            holders = set(store.replicas(block))
            while len(holders) < self.replicas:
                target = _least_loaded(load, holders)
                if target is None:
                    break
                holders.add(target)
                load[target] += 1
                added.append((block, target))
        return PlacementDelta(tuple(added), ())


REPLICATION_POLICIES["checkpoint"] = CheckpointManifestPolicy
