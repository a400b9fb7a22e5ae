"""Carry jobs, problems and model parameters over from the reference package.

The port and the reference each define their own ``Job``,
``TaskGroup`` and ``AssignmentProblem``.  These functions rebuild the
port's objects field for field from any objects with the same
attributes (``job_id``, ``arrival``, ``groups`` of ``size``/``servers``,
``mu``, ``busy``), as numpy arrays, without importing the reference.
:func:`from_reference_params` turns the reference's parameter tree
(nested dicts of numpy arrays) into the port's model.  Parity tests use
them to feed both packages the same trace, busy state and weights.
"""

from __future__ import annotations

from typing import Iterable, Mapping

import numpy as np
import torch

from . import backend
from .core import AssignmentProblem, Job, TaskGroup
from .models.config import ModelConfig
from .models.model import FAMILIES, LM, check_family

__all__ = ["from_reference_jobs", "from_reference_params", "from_reference_problem"]


def _groups(groups) -> tuple[TaskGroup, ...]:
    return tuple(
        TaskGroup(int(g.size), tuple(int(s) for s in g.servers)) for g in groups
    )


def from_reference_jobs(jobs: Iterable) -> list[Job]:
    """The port's :class:`~repro_torch.core.Job` for each reference job."""
    return [
        Job(
            job_id=int(j.job_id),
            arrival=int(j.arrival),
            groups=_groups(j.groups),
            mu=np.array(j.mu, copy=True),
        )
        for j in jobs
    ]


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


@torch.no_grad()
def from_reference_params(tree: Mapping, cfg: ModelConfig) -> LM:
    """The port's model of ``cfg``'s family holding the reference's
    parameters, on :func:`backend.device`.

    ``tree`` is the reference's ``init_params`` output with its leaves as
    numpy arrays.  The reference stacks the layers on axis 0 of every
    ``layers`` leaf (zamba2's too, flat over all its Mamba2 layers); the
    port keeps one module per layer.  Other subtrees (zamba2's
    ``shared_attn``) map by name.  Both keep projection weights as
    ``(fan_in, fan_out)``, so no leaf is transposed.  Every leaf must
    land on a parameter of the same shape and dtype, and every parameter
    must be filled.
    """
    check_family(cfg)
    params = FAMILIES[cfg.block_pattern](cfg, device=backend.device())
    leaves = _flatten(tree)
    used = set()
    for name, param in params.named_parameters():
        path = tuple(name.split("."))
        if path[0] == "layers":
            key, index = ("layers",) + path[2:], int(path[1])
        else:
            key, index = path, None
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
