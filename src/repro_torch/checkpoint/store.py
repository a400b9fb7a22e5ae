"""Checkpoint store: per-leaf .npy files + a JSON manifest.

The port's counterpart of ``repro/checkpoint/store.py``, with the same
layout on disk, so each package reads the other's checkpoints::

    <dir>/step_<N:08d>/
        manifest.json              # step; per leaf: file, name, shape,
                                   # dtype, raw_bytes, crc32
        <i:04d>_<name[:80]>.npy    # one file per tree leaf

- **the tree** — nested dicts (keys in sorted order) and lists/tuples
  (by index), as ``jax.tree_util`` flattens them; a leaf's name joins
  its path's keys with ``_``; leaves are tensors, numpy arrays or
  Python numbers;
- **bfloat16** — numpy's ``.npy`` has no bfloat16, so such a leaf is
  written as its raw bytes (a ``uint8`` vector) with ``dtype``
  ``"bfloat16"`` and ``raw_bytes`` true, and read back with
  ``torch.frombuffer``: no ``ml_dtypes`` and no ``jax`` are needed;
- **integrity** — every leaf carries the crc32 of its bytes; restore
  verifies it before returning (a torn write is detected);
- **atomicity** — written to ``step_<N>.tmp``, then renamed;
- **restore onto a device** — leaves are read on the host and moved
  to the device asked for (by default where the ``like`` tree's leaf
  lies);
- **async save** — :meth:`CheckpointManager.save_async` copies the tree
  to the host now and writes it on a background thread;
- **sharded state** — under an initialised process group every rank
  calls the save: a ``DTensor`` leaf is gathered and written as its full
  tensor, by rank 0 only (the same layout), and the others wait for the
  write; :func:`restore_checkpoint` with ``shardings=(mesh, specs)``
  places each leaf onto that mesh's blocks, which may be another mesh's
  than the one it was saved from (the reference's elastic restart).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any, Mapping

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..parallel.sharding import shard_state

__all__ = [
    "CheckpointManager",
    "latest_step",
    "read_manifest",
    "restore_checkpoint",
    "save_checkpoint",
]

_RAW_DTYPES = {torch.bfloat16: "bfloat16"}  # dtypes .npy cannot hold


def _flatten(tree: Any, path: tuple = ()) -> list[tuple[tuple, Any]]:
    """``(path, leaf)`` pairs in ``jax.tree_util``'s order: a dict's keys
    sorted, a list's or tuple's items by index; None holds no leaf."""
    if isinstance(tree, Mapping):
        return [pair for k in sorted(tree) for pair in _flatten(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pair for i, v in enumerate(tree) for pair in _flatten(v, path + (i,))]
    if tree is None:
        return []
    return [(path, tree)]


def _unflatten(like: Any, leaves: list) -> Any:
    """``like``'s structure with its leaves taken from ``leaves`` in order."""
    if isinstance(like, Mapping):
        out = {}
        for k in sorted(like):
            out[k] = _unflatten(like[k], leaves)
        return {k: out[k] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    if like is None:
        return None
    return leaves.pop(0)


def _host(leaf: Any) -> tuple[np.ndarray, str]:
    """The leaf as a host array to write (raw bytes for bfloat16) and its
    dtype's name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype in _RAW_DTYPES:
            return t.reshape(-1).view(torch.uint8).numpy(), _RAW_DTYPES[t.dtype]
        return t.numpy(), str(t.numpy().dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _writer() -> bool:
    """Whether this process writes: always, but under an initialised
    process group only rank 0."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _full(tree: Any) -> Any:
    """``tree`` with each ``DTensor`` leaf gathered into its full tensor (a
    collective: every rank calls it)."""
    return _unflatten(tree, [leaf.full_tensor() if isinstance(leaf, DTensor) else leaf
                             for _, leaf in _flatten(tree)])


def save_checkpoint(directory: str, step: int, tree: Any) -> str:
    """Synchronous atomic save; returns the final path.  Under an
    initialised process group every rank calls it: ``DTensor`` leaves are
    gathered, rank 0 writes, and every rank returns once it has."""
    tree = _full(tree)
    final = _write(directory, step, tree) if _writer() else _final(directory, step)
    if dist.is_initialized():
        dist.barrier()
    return final


def _final(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def _write(directory: str, step: int, tree: Any) -> str:
    final = _final(directory, step)
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest: dict = {"step": step, "leaves": []}
    for i, (path, leaf) in enumerate(_flatten(tree)):
        name = "_".join(str(p) for p in path)
        fname = f"{i:04d}_{name[:80]}.npy"
        arr, dtype = _host(leaf)
        raw = dtype in _RAW_DTYPES.values()
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append({
            "file": fname,
            "name": name,
            "shape": list(leaf.shape) if raw else list(arr.shape),
            "dtype": dtype,
            "raw_bytes": raw,
            "crc32": zlib.crc32(np.ascontiguousarray(arr).tobytes()),
        })
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):  # overwrite-safe
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _steps(directory: str) -> list[int]:
    return [
        int(d.split("_")[1])
        for d in os.listdir(directory)
        if d.startswith("step_") and not d.endswith(".tmp")
    ]


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return max(steps) if steps else None


def read_manifest(directory: str, step: int) -> dict:
    """Load and schema-check ``step_<N>/manifest.json``: a ``step`` and a
    ``leaves`` list whose entries carry ``file``/``name``/``shape``/
    ``dtype``/``crc32`` (the contract restore and
    :mod:`repro_torch.placement.checkpoint` rely on).  Raises
    :class:`FileNotFoundError` when the step is missing and
    :class:`ValueError` on a malformed manifest."""
    path = os.path.join(directory, f"step_{step:08d}", "manifest.json")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint manifest at {path!r}")
    with open(path) as f:
        manifest = json.load(f)
    if not isinstance(manifest, dict) or "step" not in manifest:
        raise ValueError(f"malformed manifest {path!r}: missing 'step'")
    leaves = manifest.get("leaves")
    if not isinstance(leaves, list):
        raise ValueError(f"malformed manifest {path!r}: missing 'leaves' list")
    for i, leaf in enumerate(leaves):
        missing = {"file", "name", "shape", "dtype", "crc32"} - set(leaf)
        if missing:
            raise ValueError(
                f"malformed manifest {path!r}: leaf {i} missing {sorted(missing)}"
            )
    return manifest


def _read_leaf(path: str, entry: dict) -> torch.Tensor:
    arr = np.load(os.path.join(path, entry["file"]))
    data = np.ascontiguousarray(arr).tobytes()
    if zlib.crc32(data) != entry["crc32"]:
        raise IOError(f"checksum mismatch in {entry['file']} (torn write?)")
    if entry.get("raw_bytes"):
        dtype = getattr(torch, entry["dtype"])
        if not data:
            return torch.empty(entry["shape"], dtype=dtype)
        return torch.frombuffer(bytearray(data), dtype=dtype).reshape(entry["shape"])
    return torch.from_numpy(np.array(arr))


def _shape(leaf: Any) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)


def restore_checkpoint(
    directory: str, step: int, like: Any, device: str | torch.device | None = None,
    *, shardings: tuple | None = None,
) -> Any:
    """Restore into the structure of ``like``: a tree of tensors in the
    checkpoint's dtypes, each on ``device`` (by default the device of
    ``like``'s leaf where that is a tensor, else the CPU).  With
    ``shardings=(mesh, specs)`` (a nested-dict tree, every rank calling)
    each leaf becomes this rank's ``DTensor`` block of it on ``mesh``, as
    the spec at its path of ``specs`` places it
    (:func:`repro_torch.parallel.shard_state`).  Raises :class:`IOError`
    on a checksum mismatch and :class:`ValueError` on a leaf count or
    shape that differs from ``like``'s."""
    path = os.path.join(directory, f"step_{step:08d}")
    manifest = read_manifest(directory, step)
    flat_like = [leaf for _, leaf in _flatten(like)]
    if len(manifest["leaves"]) != len(flat_like):
        raise ValueError(
            f"checkpoint has {len(manifest['leaves'])} leaves, expected {len(flat_like)}"
        )
    tensors = []
    for entry, ref in zip(manifest["leaves"], flat_like):
        t = _read_leaf(path, entry)
        if tuple(t.shape) != _shape(ref):
            raise ValueError(f"shape mismatch {entry['name']}: {tuple(t.shape)} vs {_shape(ref)}")
        where = device if device is not None else (
            ref.device if isinstance(ref, torch.Tensor) else "cpu")
        tensors.append(t.to(where))
    tree = _unflatten(like, tensors)
    if shardings is not None:
        mesh, specs = shardings
        tree = shard_state(mesh, tree, specs)
    return tree


class CheckpointManager:
    """Keeps the last ``keep`` checkpoints; optional async writes."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: threading.Thread | None = None

    def _gc(self) -> None:
        if not _writer() or not os.path.isdir(self.directory):
            return
        for s in sorted(_steps(self.directory))[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"))

    def save(self, step: int, tree: Any) -> None:
        save_checkpoint(self.directory, step, tree)
        self._gc()

    def save_async(self, step: int, tree: Any) -> None:
        """Copy the tree to the host now (gathering ``DTensor`` leaves: every
        rank calls it); write it in the background (rank 0 only under a
        process group)."""
        self.wait()
        host = _unflatten(tree, [
            leaf.detach().to("cpu", copy=True) if isinstance(leaf, torch.Tensor)
            else np.array(leaf) for _, leaf in _flatten(_full(tree))])
        if _writer():
            self._thread = threading.Thread(target=self._write, args=(step, host))
            self._thread.start()

    def _write(self, step: int, host: Any) -> None:
        _write(self.directory, step, host)
        self._gc()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore_latest(self, like: Any, device: str | torch.device | None = None,
                       *, shardings: tuple | None = None):
        step = latest_step(self.directory)
        if step is None:
            return None, None
        return step, restore_checkpoint(self.directory, step, like, device,
                                        shardings=shardings)
