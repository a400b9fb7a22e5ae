"""Mesh construction.

The port's counterpart of ``repro/launch/mesh.py``.  Functions, not
module-level constants: importing this module touches no process group
and no device.  Both need an initialised default process group
(``torch.distributed.init_process_group``) spanning exactly the mesh.
"""

from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["make_mesh", "make_production_mesh"]


def make_mesh(shape: tuple[int, ...], names: tuple[str, ...],
              device_type: str = "cuda") -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` over the initialised world, axes named
    ``names`` (rank-major: the last axis varies fastest).  Raises
    :class:`RuntimeError` when no process group is initialised or its
    world size is not the mesh's size."""
    need = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(f"a {dict(zip(names, shape))} mesh needs an initialised process "
                           f"group of world size {need}; none is initialised")
    if dist.get_world_size() != need:
        raise RuntimeError(f"a {dict(zip(names, shape))} mesh needs world size {need}; "
                           f"the process group has {dist.get_world_size()}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """Single pod: (data=16, model=16) = 256 ranks, one device each.
    Multi-pod: (pod=2, data=16, model=16) = 512; ``pod`` is pure data
    parallelism across the pods' interconnect."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"), device_type)
    return make_mesh((16, 16), ("data", "model"), device_type)
