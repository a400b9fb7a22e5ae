"""Carry jobs, problems, timelines, stores and model parameters over
from the reference package.

The port and the reference each define their own ``Job``,
``TaskGroup``, ``AssignmentProblem``, events, placement store and
resilience config.  These functions rebuild the port's objects field for
field from any objects with the same attributes (``job_id``,
``arrival``, ``groups`` of ``size``/``servers``, ``mu``, ``busy``,
``blocks``; an event's ``slot``/``kind``/...), as numpy arrays, without
importing the reference.  :func:`from_reference_params` turns the
reference's parameter tree (nested dicts of numpy arrays) into the
port's model.  Parity tests use them to feed both packages the same
trace, fault and churn timeline, placement state, busy state and
weights.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping

import numpy as np
import torch

from . import backend
from .core import AssignmentProblem, Job, TaskGroup
from .models.config import ModelConfig
from .models.model import FAMILIES, LM, check_family
from .placement import (
    REPLICATION_POLICIES,
    PlacedJob,
    PlacementEvent,
    PlacementStore,
)
from .runtime.events import RackEvent, ServerEvent
from .runtime.resilience import ResilienceConfig

__all__ = [
    "from_reference_events",
    "from_reference_jobs",
    "from_reference_params",
    "from_reference_problem",
    "from_reference_resilience",
    "from_reference_store",
    "reference_leaf",
    "reference_names",
]


def _groups(groups) -> tuple[TaskGroup, ...]:
    return tuple(
        TaskGroup(int(g.size), tuple(int(s) for s in g.servers)) for g in groups
    )


def from_reference_jobs(jobs: Iterable) -> list[Job]:
    """The port's :class:`~repro_torch.core.Job` for each reference job;
    a placement-backed job (one with ``blocks``) becomes a
    :class:`~repro_torch.placement.PlacedJob`."""
    out: list[Job] = []
    for j in jobs:
        fields = dict(
            job_id=int(j.job_id),
            arrival=int(j.arrival),
            groups=_groups(j.groups),
            mu=np.array(j.mu, copy=True),
        )
        blocks = getattr(j, "blocks", None)
        out.append(
            Job(**fields) if blocks is None else PlacedJob(**fields, blocks=tuple(blocks))
        )
    return out


def from_reference_events(events: Iterable) -> tuple:
    """The port's ``ServerEvent`` / ``RackEvent`` / ``PlacementEvent`` for
    each reference event (told apart by class name), in order."""
    out = []
    for ev in events:
        kind = type(ev).__name__
        if kind == "ServerEvent":
            out.append(ServerEvent(int(ev.slot), ev.kind, int(ev.server), float(ev.factor)))
        elif kind == "RackEvent":
            out.append(RackEvent(int(ev.slot), ev.kind, tuple(int(m) for m in ev.servers)))
        elif kind == "PlacementEvent":
            out.append(PlacementEvent(
                int(ev.slot), ev.kind, ev.block,
                None if ev.server is None else int(ev.server), int(ev.seed),
            ))
        else:
            raise TypeError(f"not a reference timeline event: {ev!r}")
    return tuple(out)


def from_reference_store(store) -> PlacementStore:
    """The port's :class:`~repro_torch.placement.PlacementStore` holding a
    reference store's state: its replication policy (same fields), every
    block's replica set, access counts, active servers and counters."""
    policy = store.policy
    cls = REPLICATION_POLICIES.get(policy.name)
    if cls is None:
        raise ValueError(f"no port replication policy {policy.name!r}")
    out = PlacementStore(store.n_servers, policy=cls(**dataclasses.asdict(policy)))
    for block, servers in store.snapshot().items():
        out._replicas[block] = {int(m) for m in servers}
        if store.access_count(block):
            out._access[block] = int(store.access_count(block))
    out._active[:] = False
    out._active[list(store.active_servers())] = True
    out.version = int(store.version)
    out.replicas_added = int(store.replicas_added)
    out.replicas_evicted = int(store.replicas_evicted)
    return out


def from_reference_resilience(cfg) -> ResilienceConfig:
    """The port's :class:`~repro_torch.runtime.resilience.ResilienceConfig`
    with a reference config's field values."""
    return ResilienceConfig(**dataclasses.asdict(cfg))


def from_reference_problem(problem) -> AssignmentProblem:
    """The port's :class:`~repro_torch.core.AssignmentProblem` for a
    reference problem (busy times, capacities and groups copied)."""
    return AssignmentProblem(
        busy=np.array(problem.busy, copy=True),
        mu=np.array(problem.mu, copy=True),
        groups=_groups(problem.groups),
    )


def _to_torch(a: np.ndarray) -> torch.Tensor:
    """A numpy array as a tensor; bfloat16 arrays (numpy's ``ml_dtypes``
    extension type, which torch does not read) go through their bits."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _flatten(tree: Mapping, prefix: tuple = ()) -> dict[tuple, np.ndarray]:
    out: dict[tuple, np.ndarray] = {}
    for key, node in tree.items():
        if isinstance(node, Mapping):
            out.update(_flatten(node, prefix + (key,)))
        else:
            out[prefix + (key,)] = np.asarray(node)
    return out


def reference_leaf(name: str) -> tuple[tuple[str, ...], int | None]:
    """Where the port's parameter ``name`` (as ``named_parameters`` gives
    it) lies in the reference's parameter tree: the key path and, for a
    layer's parameter, its index on the stacked axis 0 of that leaf
    (``"layers.3.attn.wq.w"`` -> ``(("layers", "attn", "wq", "w"), 3)``;
    Whisper's ``"encoder.layers.3.attn.wq.w"`` -> ``(("encoder", "layers",
    "attn", "wq", "w"), 3)``); every other parameter maps by name with no
    index."""
    path = tuple(name.split("."))
    if path[0] == "layers":
        return ("layers",) + path[2:], int(path[1])
    if path[:2] == ("encoder", "layers"):
        return path[:2] + path[3:], int(path[2])
    return path, None


def reference_names(params: LM) -> dict[str, tuple[tuple[str, ...], int | None]]:
    """:func:`reference_leaf` of every parameter of ``params``: the name
    map the tests use to compare gradients and updated parameters leaf by
    leaf with the reference's."""
    return {name: reference_leaf(name) for name, _ in params.named_parameters()}


@torch.no_grad()
def from_reference_params(tree: Mapping, cfg: ModelConfig) -> LM:
    """The port's model of ``cfg``'s family holding the reference's
    parameters, on :func:`backend.device`.

    ``tree`` is the reference's ``init_params`` output with its leaves as
    numpy arrays (the vlm family's are the dense decoder's).  The
    reference stacks the layers on axis 0 of every ``layers`` leaf
    (zamba2's too, flat over all its Mamba2 layers, and Whisper's
    ``encoder/layers``); the port keeps one module per layer.  The
    decoder's cross-attention leaves (``layers/cross/...``,
    ``layers/norm_x``) ride the ``layers`` rule.  Other subtrees (zamba2's
    ``shared_attn``, DeepSeek's MTP head ``mtp``, whose ``block`` is not
    stacked) map by name, as do the MoE leaves: the router
    ``ffn/router/w``, the routed experts as bare ``(E, ...)`` arrays
    ``ffn/experts/wi_gate`` (no ``/w``) and the shared expert
    ``ffn/shared/wi_gate/w``.  Both keep projection weights as
    ``(fan_in, fan_out)``, so no leaf is transposed.  Every leaf must
    land on a parameter of the same shape and dtype, and every parameter
    must be filled.
    """
    check_family(cfg)
    params = FAMILIES[cfg.block_pattern](cfg, device=backend.device())
    leaves = _flatten(tree)
    used = set()
    for name, param in params.named_parameters():
        key, index = reference_leaf(name)
        if key not in leaves:
            raise KeyError(f"reference tree has no leaf {'/'.join(key)} for {name}")
        leaf = leaves[key]
        used.add(key)
        value = _to_torch(leaf if index is None else leaf[index])
        if value.shape != param.shape or value.dtype != param.dtype:
            raise ValueError(
                f"{name}: reference leaf {tuple(value.shape)} {value.dtype}, "
                f"port parameter {tuple(param.shape)} {param.dtype}"
            )
        param.copy_(value)
    extra = ["/".join(k) for k in leaves if k not in used]
    if extra:
        raise KeyError(f"reference leaves with no port parameter: {extra}")
    return params
