"""The ambient mesh, and activation layouts resolved against it.

The port's counterpart of ``repro/parallel/constrain.py`` (and of
``compat.set_mesh``, since the port has no jax-version shim).  The
launchers scope a mesh with :func:`set_mesh`; :func:`ambient_mesh` reads
it (None outside any scope, so the model stays mesh-agnostic).
:func:`logical_spec` resolves logical tags ("dp" | "model" | None) to a
spec of the mesh's axes, and :func:`shard` lays a ``DTensor`` out on it.

The port runs SPMD: a rank holds plain tensors, its own blocks, so there
is no layout propagation to pin and the model carries no :func:`shard`
calls.  The one reader of the ambient state in the model is the MoE
dispatch (:mod:`repro_torch.models.moe_sharded`), which also needs to
know whether the activations it sees are this rank's block of the batch:
the sharded train step scopes that with :func:`split_batch`.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch
from torch.distributed.tensor import DTensor

from .sharding import mesh_sizes, placements

__all__ = ["ambient_mesh", "batch_axes", "logical_spec", "set_mesh", "shard", "split_batch"]

# the innermost scope's mesh, and the mesh axes the activations' batch
# dim is split on (empty: every rank holds the whole batch)
_stack: list[tuple] = [(None, ())]


def ambient_mesh():
    """The ambient ``DeviceMesh``, or None outside :func:`set_mesh`."""
    return _stack[-1][0]


def batch_axes() -> tuple[str, ...]:
    """The mesh axes the batch dim of the model's activations is split on
    in the innermost scope: () unless :func:`split_batch` says so."""
    return _stack[-1][1]


@contextlib.contextmanager
def set_mesh(mesh) -> Iterator:
    """Scope ``mesh`` as the ambient mesh (the activations whole on every
    rank until :func:`split_batch`); scopes nest and restore on exit."""
    _stack.append((mesh, ()))
    try:
        yield mesh
    finally:
        _stack.pop()


@contextlib.contextmanager
def split_batch(axes: tuple[str, ...]) -> Iterator:
    """Within the ambient mesh's scope, the activations are this rank's
    block of the batch, split on ``axes`` (major first)."""
    mesh = ambient_mesh()
    if mesh is None:
        raise RuntimeError("split_batch needs an ambient mesh (set_mesh)")
    _stack.append((mesh, tuple(axes)))
    try:
        yield
    finally:
        _stack.pop()


def logical_spec(mesh, *tags) -> tuple:
    """Resolve logical tags ("dp" | "model" | None | a mesh axis) against a
    mesh: "dp" -> ("pod", "data") or "data" (None without either)."""
    names = mesh.mesh_dim_names
    axes = []
    for t in tags:
        if t == "dp":
            dp = tuple(a for a in ("pod", "data") if a in names)
            axes.append(None if not dp else dp[0] if len(dp) == 1 else dp)
        elif t is None:
            axes.append(None)
        else:  # "model" or an explicit mesh axis name
            axes.append(t if t in names else None)
    return tuple(axes)


def shard(x: torch.Tensor, *tags) -> torch.Tensor:
    """Lay a ``DTensor`` out on the logical spec of the ambient mesh (an
    axis whose extent does not divide its dim replicates).  The identity
    with no ambient mesh, and on a plain tensor, which is already this
    rank's block."""
    mesh = ambient_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    sizes = mesh_sizes(mesh)
    fixed = []
    for dim, axes in zip(x.shape, logical_spec(mesh, *tags)):
        names = () if axes is None else (axes,) if isinstance(axes, str) else axes
        extent = 1
        for n in names:
            extent *= sizes[n]
        fixed.append(axes if dim % extent == 0 else None)
    return x.redistribute(mesh, placements(mesh, tuple(fixed)))
