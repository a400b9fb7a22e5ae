"""Sharding rules: parameters (FSDP x TP x EP), batches and decode caches.

The port's counterpart of ``repro/parallel/sharding.py``, on
``torch.distributed.device_mesh.DeviceMesh``.  Mesh axes
(:mod:`repro_torch.launch.mesh`): optional ``pod`` (data-parallel across
pods), ``data`` (FSDP / DP), ``model`` (TP / EP).  A *spec* is what the
reference's ``PartitionSpec`` is: a tuple with one entry per tensor dim,
each a mesh-axis name, a tuple of names (one dim split over several
axes, the first the major one) or ``None`` (replicated); a tuple of one
name is written as the name, as ``PartitionSpec`` normalises it.  Rules
are path-based with a divisibility fallback: a dim is sharded on an axis
only when the axis extent divides it, otherwise replicated on it.

Summary (fsdp = ("pod", "data") or "data"; the reference's stacked
layer axis has no counterpart: the port keeps one module per layer, so a
layer's parameter takes the reference's spec without its leading None)::

  embed.table        (V, D)     -> ("model", fsdp)
  attn wq/wk/wv      (D, H*h)   -> (fsdp, "model")
  attn wo            (H*h, D)   -> ("model", fsdp)
  mla wq_b/wkv_b     (r, H*x)   -> (fsdp, "model")
  ffn wi_gate/wi_up  (D, F)     -> (fsdp, "model")
  ffn wo             (F, D)     -> ("model", fsdp)
  moe experts        (E, D, F)  -> ("model", fsdp, None)   [EP]
  mamba in_proj      (D, F)     -> (fsdp, "model")
  everything else    replicated (norms, biases, scalars)

A parameter's path is the reference's (:func:`repro_torch.convert.
reference_leaf` of its name, joined with ``/``), so the same string
tests pick the same rule.  The optimizer moments shard as their
parameters.  :func:`placements` turns a spec into ``torch.distributed.
tensor`` placements; :func:`shard_state` cuts a tree of full tensors
(held identically by every rank) into each rank's ``DTensor`` blocks and
:func:`gather_state` puts them back together.  The rules themselves need
only the mesh's axis names and sizes: an :class:`AbstractMesh` gives
them without a process group.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

__all__ = [
    "AbstractMesh",
    "batch_sharding",
    "cache_sharding",
    "data_shard",
    "fsdp_axes",
    "gather_state",
    "local_block",
    "mesh_sizes",
    "param_sharding",
    "placements",
    "replicated",
    "serve_param_sharding",
    "shard_state",
]


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes without devices or a process group (the
    reference's ``jax.sharding.AbstractMesh``): enough for the rules."""

    shape: tuple[int, ...]
    mesh_dim_names: tuple[str, ...]


def mesh_sizes(mesh) -> dict[str, int]:
    """``{axis name: extent}`` of a ``DeviceMesh`` or :class:`AbstractMesh`."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def fsdp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes: ('pod', 'data') if multi-pod else ('data',)."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def data_shard(mesh) -> tuple[int, int]:
    """``(n, index)``: the number of data-parallel shards (the product of
    the :func:`fsdp_axes`) and this rank's, the major axis first."""
    sizes = mesh_sizes(mesh)
    n, index = 1, 0
    for a in fsdp_axes(mesh):
        n *= sizes[a]
        index = index * sizes[a] + mesh.get_local_rank(a)
    return n, index


def _names(axes) -> tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _axis_size(mesh, axes) -> int:
    sizes = mesh_sizes(mesh)
    return math.prod(sizes[a] for a in _names(axes))


def _entry(axes):
    """A spec entry as ``PartitionSpec`` keeps it: one name alone, not in a
    tuple; an empty tuple is None."""
    names = _names(axes)
    if not names:
        return None
    return names[0] if len(names) == 1 else names


def _fit(mesh, shape: tuple[int, ...], want: tuple) -> tuple:
    """Drop axis assignments whose extent does not divide the dim size."""
    out = []
    for dim, axes in zip(shape, want):
        out.append(_entry(axes) if axes is not None and dim % _axis_size(mesh, axes) == 0
                   else None)
    return tuple(out)


def _param_spec(mesh, path: str, shape: tuple[int, ...]) -> tuple:
    fsdp = fsdp_axes(mesh)
    nd = len(shape)

    def with_layer(spec_tail: tuple) -> tuple:
        """Nones for any leading axes the tail does not name."""
        return _fit(mesh, shape, (None,) * (nd - len(spec_tail)) + spec_tail)

    if path.endswith("embed/table"):
        return _fit(mesh, shape, ("model", fsdp))
    if "/experts/" in path:  # (E, D, F) / (E, F, D)
        return with_layer(("model", fsdp, None))
    if path.endswith("router/w"):
        return with_layer((fsdp, None))
    if path.endswith(("wq/w", "wk/w", "wv/w", "wq_b/w", "wkv_b/w",
                      "wi_gate/w", "wi_up/w", "in_proj/w")):
        return with_layer((fsdp, "model"))
    if path.endswith(("wo/w", "out_proj")):
        return with_layer(("model", fsdp))
    if path.endswith(("wq_a/w", "wkv_a/w", "proj/w")):
        return with_layer((fsdp, None))
    if path.endswith(("wq/b", "wk/b", "wv/b", "wi_gate/b", "wi_up/b", "in_proj/b")):
        return with_layer(("model",))
    return (None,) * nd


def _leaves(tree: Any, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """``(key path, leaf)`` of a nested dict, or of a module's parameters
    (their dotted names split)."""
    if isinstance(tree, torch.nn.Module):
        return [(tuple(n.split(".")), p) for n, p in tree.named_parameters()]
    if isinstance(tree, Mapping):
        return [pair for k, v in tree.items() for pair in _leaves(v, prefix + (str(k),))]
    return [(prefix, tree)]


def _nest(pairs) -> dict:
    out: dict = {}
    for path, value in pairs:
        node = out
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = value
    return out


def _ref_path(path: tuple) -> str:
    from ..convert import reference_leaf  # convert imports the models, which import us

    return "/".join(reference_leaf(".".join(path))[0])


def param_sharding(mesh, params: Any) -> dict:
    """The spec of every parameter, as a nested dict keyed like
    ``param_tree(params)``; ``params`` is a model or such a tree (of
    tensors, or of anything with a ``shape``: the moments too)."""
    return _nest((path, _param_spec(mesh, _ref_path(path), tuple(x.shape)))
                 for path, x in _leaves(params))


def serve_param_sharding(mesh, params: Any) -> dict:
    """Decode-time parameter sharding: weights resident, tensor-parallel
    on ``model`` and replicated over the data axes, except the MoE expert
    tensors, which keep the train sharding (the expert axis on ``model``,
    d_model on the data axes)."""
    dp = fsdp_axes(mesh)

    def leaf(path: tuple, x) -> tuple:
        name, shape = _ref_path(path), tuple(x.shape)
        if "/experts/" in name:
            return _fit(mesh, shape, (None,) * (len(shape) - 3) + ("model", dp, None))
        cleaned = tuple("model" if "model" in _names(axes) else None
                        for axes in _param_spec(mesh, name, shape))
        return _fit(mesh, shape, cleaned)

    return _nest((path, leaf(path, x)) for path, x in _leaves(params))


def replicated(mesh, tree: Any) -> dict:
    """``()`` (every mesh axis replicated) for every leaf of ``tree``."""
    return _nest((path, ()) for path, _ in _leaves(tree))


def batch_sharding(mesh, batch: Any) -> dict:
    """The batch dim on the data-parallel axes when divisible, else
    replicated."""
    dp = fsdp_axes(mesh)
    return _nest((path, _fit(mesh, tuple(x.shape), (dp,) + (None,) * (len(x.shape) - 1)))
                 for path, x in _leaves(batch))


# the port's cache leaves that the reference lays out otherwise: the KV
# leaves are (L, B, Hkv, S, hd) here and (L, B, S, Hkv, hd) there
_KV_TO_REFERENCE = (0, 1, 3, 2, 4)


def _kv_spec(mesh, shape: tuple[int, ...]) -> tuple:
    """The reference's rule for an (L, B, S, heads?, hd?) leaf: batch on the
    data-parallel axes, else the sequence on ``data``; the sequence on
    ``model`` where free, else the heads or head dim."""
    dp = fsdp_axes(mesh)
    sizes = mesh_sizes(mesh)
    want: list = [None] * len(shape)
    if shape[1] % _axis_size(mesh, dp) == 0:
        want[1] = dp
    elif shape[2] % sizes["data"] == 0:
        want[2] = "data"
    if want[2] is None and shape[2] % sizes["model"] == 0:
        want[2] = "model"
    else:
        for axis in (3, 4):
            if len(shape) > axis and shape[axis] % sizes["model"] == 0:
                want[axis] = "model"
                break
    return _fit(mesh, shape, tuple(want))


def cache_sharding(mesh, cache: Any) -> dict:
    """Decode-cache sharding, the reference's rules on the port's layouts.

    Leaves are (L, B, ...): ``pos`` and leaves under 3 dims replicate;
    ``memory`` (B, T, D) takes the batch on the data-parallel axes; a
    Mamba2 state (``conv``, ``ssm``; zamba2's stacked flat over its
    layers) the batch on them too; the KV leaves (``k``, ``v``: (L, B,
    Hkv, S, hd)) and MLA's rows (``c_kv``, ``k_rope``: (L, B, S, r)) take
    the reference's sequence-parallel rule, computed in the reference's
    axis order and permuted back for ``k`` / ``v``."""
    dp = fsdp_axes(mesh)

    def leaf(path: tuple, x) -> tuple:
        shape, name = tuple(x.shape), "/".join(path)
        if name.endswith("pos") or len(shape) < 3:
            return ()
        if name.endswith("memory"):
            return _fit(mesh, shape, (dp, None, None))
        if name.endswith(("conv", "ssm")):
            return _fit(mesh, shape, (None, dp) + (None,) * (len(shape) - 2))
        if name.endswith(("/k", "/v")):
            perm = _KV_TO_REFERENCE
            spec = _kv_spec(mesh, tuple(shape[i] for i in perm))
            return tuple(spec[perm.index(i)] for i in range(len(shape)))
        return _kv_spec(mesh, shape)

    return _nest((path, leaf(path, x)) for path, x in _leaves(cache))


# ---- specs onto a DeviceMesh ------------------------------------------------


def placements(mesh, spec: tuple) -> list:
    """The ``torch.distributed.tensor`` placements of ``spec``: per mesh
    dim, ``Shard(d)`` where tensor dim d names that axis, else
    ``Replicate()``.  A dim split over several axes names them major
    first, in the mesh's order, as DTensor splits it."""
    out: list = [Replicate()] * len(mesh.mesh_dim_names)
    order = {a: i for i, a in enumerate(mesh.mesh_dim_names)}
    for d, axes in enumerate(spec):
        names = _names(axes)
        dims = [order[a] for a in names]
        if dims != sorted(dims):
            raise ValueError(f"spec {spec!r}: dim {d} names {names} out of the mesh's "
                             f"order {mesh.mesh_dim_names}")
        for i in dims:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec!r} names mesh axis "
                                 f"{mesh.mesh_dim_names[i]!r} twice")
            out[i] = Shard(d)
    return out


def local_block(mesh, full: torch.Tensor, spec: tuple) -> torch.Tensor:
    """This rank's block of ``full`` under ``spec`` (a copy)."""
    coord = mesh.get_coordinate()
    block = full
    for i, p in enumerate(placements(mesh, spec)):
        if isinstance(p, Shard):
            block = block.chunk(mesh.shape[i], dim=p.dim)[coord[i]]
    return block.clone()


def _spec_leaves(specs: Any, prefix: tuple = ()) -> dict[tuple, tuple]:
    """A spec tree's leaves by key path (a spec is a tuple, so nested
    dicts only are walked)."""
    if isinstance(specs, Mapping):
        out: dict = {}
        for k, v in specs.items():
            out.update(_spec_leaves(v, prefix + (str(k),)))
        return out
    return {prefix: specs}


def shard_state(mesh, tree: Any, specs: Any) -> dict:
    """Each rank's ``DTensor`` blocks of a tree of full tensors that every
    rank holds identically (a model's parameters, or a nested dict such
    as ``TrainState.tree()``), placed by the spec at the same path of
    ``specs``.  No communication: each rank cuts its own block."""
    by_path = _spec_leaves(specs)
    return _nest(
        (path, DTensor.from_local(local_block(mesh, t.detach(), by_path[path]), mesh,
                                  placements(mesh, by_path[path]), run_check=False,
                                  shape=t.shape, stride=t.stride()))
        for path, t in _leaves(tree))


def gather_state(tree: Any) -> dict:
    """The full tensors of a tree of ``DTensor`` s (every rank gets them;
    a collective); other leaves pass through."""
    return _nest((path, t.full_tensor() if isinstance(t, DTensor) else t)
                 for path, t in _leaves(tree))
