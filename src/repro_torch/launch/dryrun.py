"""Multi-pod dry run: count every (arch x shape x mesh) cell's step, per
rank, on the ``meta`` device.

The port's counterpart of ``repro/launch/dryrun.py``.  The reference
lowers and compiles each cell with XLA on 512 fake host devices and
reads its cost and memory analyses.  The port has no compiler to ask,
so it runs the step itself, once, on ``meta`` tensors (nothing is
allocated, no kernel launches) as one rank of a world of 256 or 512
ranks that exists in this process:

- **the world**: ``torch.distributed`` with the ``fake`` backend (torch's
  ``FakeStore``; every collective returns at once, the outputs'
  contents undefined) at ``rank`` of ``world_size`` ranks
  (:func:`fake_world`), and the production mesh on it
  (:func:`repro_torch.launch.mesh.make_production_mesh`), destroyed after
  the cell;
- **the step**: :func:`repro_torch.launch.specs.step_fn_for` with the
  mesh, its arguments this rank's blocks (strategy ``"gathered"``: the
  parameters gathered whole once a step, the batch's rows split over
  the data axes; :mod:`.specs`).  The per-device numbers are rank 0's;
- **the counters** (:func:`count_step`), around one call:
  ``FlopCounterMode`` for ``flops_per_device``, plus the model kernels'
  own operation counts (K4-K7 count themselves inside
  ``kernels._tensors.counting``: a ``meta`` input gets the kernel's
  shape rule, never its plain version); this module's dispatch mode for
  ``bytes_per_device`` (each aten op's tensor inputs read plus its
  outputs written, which is what eager PyTorch moves; views and fresh
  allocations move nothing; the kernels by their byte rules), for the
  collectives (each call's operand bytes and group, its wire bytes by
  the reference's ring factors, ``repro/launch/hlo.py``) and for the
  memory (storage bytes added when an op creates them and taken off when
  they are freed); ``CommDebugMode`` counts the collective calls too,
  and the two counts must agree.  The collective counts are the calls
  the step made, not a formula of what it should make;
- **memory**: ``argument_bytes`` (this rank's blocks of the state and
  batch, or of the parameters, tokens and cache), ``output_bytes`` (the
  step's outputs on this rank), ``temp_bytes`` (the peak of live storage
  created during the step, above the arguments), ``peak_bytes``
  (arguments plus temp), ``hbm_bytes`` (an H100 80GB HBM3's
  ``total_memory``) and ``fits``.  A cell that does not fit is still
  ``"ok"`` with ``"fits": false``, as the reference compiles a cell
  whatever its memory: e.g. DeepSeek-V3's train step gathers its 1.43 TB
  of bf16 parameters on every rank.

A cell's JSON has the reference's keys (``count_wall_s``, the wall time
of the counted step, in place of ``lower_s`` / ``compile_s``) plus
``strategy``, ``peak_bytes``, ``hbm_bytes``, ``fits`` and ``rank``.  An
exception marks the cell ``"error"`` with its message and the sweep goes
on; the run exits 1 if any cell erred.  Skipped cells carry the
reference's reason.  It needs no card and runs on the CPU.

Run:  PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A]
      [--shape S] [--mesh single|multi|both] [--out results/dryrun_torch]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import traceback
import weakref
from typing import Any, Callable, Iterator

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from ..backend import set_backend
from ..configs import ARCHS, get_config
from ..configs.shapes import SHAPES, ShapeSpec, applicable, get_shape
from ..kernels import _tensors as kernel_counts
from ..models.config import ModelConfig
from ..obs.clock import perf_counter
from ..parallel.sharding import batch_sharding, cache_sharding, param_sharding
from ..train import AdamWConfig, TrainState
from ..train.step import state_sharding
from .mesh import make_production_mesh
from .specs import GATHERED, cache_specs, input_specs, param_specs, state_specs, step_fn_for

__all__ = [
    "HBM_BYTES",
    "NODE_GPUS",
    "StepCounts",
    "count_cell",
    "count_step",
    "fake_world",
    "main",
    "run_cell",
    "shardings_for",
]

HBM_BYTES = 85_017_493_504  # total_memory of an H100 80GB HBM3 (chip_smoke.py checks it)
NODE_GPUS = 8  # GPUs a node: a group within one node talks over NVLink
RESULTS_DEFAULT = os.path.join(os.path.dirname(__file__), "..", "..", "..", "results",
                               "dryrun_torch")

# collective ops (c10d's and the functional collectives') by the
# reference's HLO kind names
_KINDS = {
    "all_gather_into_tensor": "all-gather", "_allgather_base_": "all-gather",
    "allgather_": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce", "allreduce_": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "broadcast": "broadcast", "broadcast_": "broadcast",
}
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional",
                          "_c10d_functional_autograd")
_aten = torch.ops.aten
_WRITE_ONLY = {_aten.fill_.Scalar, _aten.fill_.Tensor, _aten.zero_.default,
               _aten.copy_.default}  # their first argument is written, not read
_NO_MOVE = {_aten.empty.memory_format, _aten.empty_strided.default, _aten.empty_like.default,
            _aten.new_empty.default, _aten.new_empty_strided.default}


def wire_bytes(kind: str, n: int, operand: int, result: int) -> float:
    """Bytes a device puts on the wire for one collective over ``n``
    ranks, by the ring factors of ``repro/launch/hlo.py``."""
    if kind == "all-reduce":
        return 2 * (n - 1) / n * operand
    if kind == "all-gather":
        return (n - 1) / n * result
    if kind in ("reduce-scatter", "all-to-all"):
        return (n - 1) / n * operand
    return float(operand)  # a single hop


@dataclasses.dataclass
class StepCounts:
    """What one rank's step did (module docstring)."""

    flops: int = 0
    bytes: int = 0
    kernels: dict = dataclasses.field(default_factory=dict)
    collective_ops: dict = dataclasses.field(default_factory=dict)
    collective_operand_bytes: dict = dataclasses.field(default_factory=dict)
    collective_wire_bytes: float = 0.0
    wire_bytes_by_link: dict = dataclasses.field(
        default_factory=lambda: {"nvlink": 0.0, "network": 0.0})
    argument_bytes: int = 0
    output_bytes: int = 0
    temp_bytes: int = 0

    @property
    def peak_bytes(self) -> int:
        return self.argument_bytes + self.temp_bytes


def _tensors(tree: Any) -> Iterator[torch.Tensor]:
    """The plain tensors of a tree of dicts, lists, tuples, modules and
    ``DTensor`` s (a ``DTensor`` gives its local block)."""
    if isinstance(tree, DTensor):
        yield tree.to_local()
    elif isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _storage(t: torch.Tensor) -> tuple[int, int]:
    st = t.untyped_storage()
    return st._cdata, st.nbytes()


def storage_bytes(tree: Any) -> int:
    """The bytes of the distinct storages a tree's tensors hold."""
    return sum(dict(_storage(t) for t in _tensors(tree)).values())


def _group_ranks(func, args) -> list[int]:
    """The ranks of a collective's group, from its process group or its
    group name."""
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.get_process_group_ranks(dist.ProcessGroup.unbox(a))
            except (RuntimeError, ValueError):  # a ReduceOp, not the group
                continue
    name = next(a for a in reversed(args) if isinstance(a, str))
    return dist.get_process_group_ranks(dist.distributed_c10d._resolve_process_group(name))


class _Tracker(TorchDispatchMode):
    """Bytes moved, live storage and collectives of the ops it sees (plain
    tensors: ``DTensor`` ops are let through to desugar first)."""

    def __init__(self, counts: StepCounts, known: set[int]):
        super().__init__()
        self.counts = counts
        self.known = set(known)  # the arguments' storages: not created here
        self.live = 0
        self.peak = 0
        self.calls = 0

    def _free(self, key: int, nbytes: int) -> None:
        self.live -= nbytes
        self.known.discard(key)  # a later storage may take its address

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace in _COLLECTIVE_NAMESPACES:
            self._collective(func, args, out)
            return out
        if func.is_view:
            return out
        ins = list(_tensors((args, kwargs)))
        outs = list(_tensors(out))
        if func not in _NO_MOVE:
            read = ins[1:] if func in _WRITE_ONLY else ins
            self.counts.bytes += sum(t.numel() * t.element_size() for t in read + outs)
        seen = {_storage(t)[0] for t in ins}
        for t in outs:
            key, nbytes = _storage(t)
            if key in seen or key in self.known:
                continue
            self.known.add(key)
            self.live += nbytes
            weakref.finalize(t.untyped_storage(), self._free, key, nbytes)
        self.peak = max(self.peak, self.live)
        return out

    def _collective(self, func, args, out) -> None:
        kind = _KINDS.get(func._overloadpacket.__name__)
        if kind is None:  # wait_tensor and the like
            return
        self.calls += 1
        ranks = _group_ranks(func, args)
        operand = sum(t.numel() * t.element_size() for t in _tensors(args))
        result = sum(t.numel() * t.element_size() for t in _tensors(out))
        c = self.counts
        c.collective_ops[kind] = c.collective_ops.get(kind, 0) + 1
        c.collective_operand_bytes[kind] = c.collective_operand_bytes.get(kind, 0) + operand
        wire = wire_bytes(kind, len(ranks), operand, result)
        c.collective_wire_bytes += wire
        link = "nvlink" if len({r // NODE_GPUS for r in ranks}) == 1 else "network"
        c.wire_bytes_by_link[link] += wire


def count_step(fn: Callable, args: tuple, *, device: str = "meta") -> tuple[Any, StepCounts]:
    """``fn(*args)`` once under ``set_backend(device=device)`` and the
    counters (module docstring); returns its output and the counts.  The
    same counts on ``meta``, on the CPU and on the card."""
    counts = StepCounts(argument_bytes=storage_bytes(args))
    tracker = _Tracker(counts, {_storage(t)[0] for t in _tensors(args)})
    flops = FlopCounterMode(display=False)
    with set_backend(device=device), kernel_counts.counting() as kernels, \
            CommDebugMode() as comm, flops, tracker:
        out = fn(*args)
    if comm.get_total_counts() != tracker.calls:
        raise RuntimeError(f"CommDebugMode counted {comm.get_total_counts()} collectives, "
                           f"the tracker {tracker.calls}")
    counts.kernels = kernels.by_kernel
    counts.flops = flops.get_total_flops() + kernels.ops
    counts.bytes += kernels.bytes
    counts.temp_bytes = tracker.peak
    counts.output_bytes = storage_bytes(out)
    return out, counts


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0) -> Iterator[None]:
    """A process group of ``world_size`` ranks in this process, as rank
    ``rank``, on torch's ``fake`` backend (collectives return at once);
    destroyed on exit.  ``torch.testing._internal.distributed.fake_pg`` is
    internal to torch: the tests pin what this relies on."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def shardings_for(mesh, cfg: ModelConfig, shape: ShapeSpec, opt_cfg: AdamWConfig) -> tuple:
    """The specs of the cell's step arguments (the reference's
    ``in_shardings``; its ``logits_sharding`` has no counterpart):
    ``(state, batch)`` for train, ``(params, batch)`` for prefill and
    ``(params, tokens, cache)`` for decode, the parameters always as
    ``param_sharding`` blocks (strategy ``"gathered"``)."""
    if shape.kind == "train":
        st = state_specs(cfg, opt_cfg)
        return (state_sharding(mesh, TrainState(**st).tree()),
                batch_sharding(mesh, input_specs(cfg, shape)))
    params = param_specs(cfg)
    if shape.kind == "prefill":
        return param_sharding(mesh, params), batch_sharding(mesh, input_specs(cfg, shape))
    tokens = batch_sharding(mesh, input_specs(cfg, shape))["tokens"]
    cache = cache_specs(cfg, shape.global_batch, shape.seq_len, params=params)
    return param_sharding(mesh, params), tokens, cache_sharding(mesh, cache)


def count_cell(cfg: ModelConfig, shape: ShapeSpec, *, multi_pod: bool,
               rank: int = 0) -> StepCounts:
    """One rank's counts of the cell's step in a fake world of 256 (or
    512) ranks on the production mesh."""
    with fake_world(512 if multi_pod else 256, rank):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        opt_cfg = AdamWConfig()
        fn, args = step_fn_for(cfg, shape, opt_cfg, mesh=mesh,
                               in_shardings=shardings_for(mesh, cfg, shape, opt_cfg))
        out, counts = count_step(fn, args)
        del out, args
    return counts


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str) -> dict:
    """Rank 0's counts of one cell, written to ``out_dir`` as JSON
    (module docstring)."""
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    cell = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
            "chips": 512 if multi_pod else 256}
    ok, reason = applicable(cfg, shape)
    if not ok:
        cell["status"] = "skipped"
        cell["reason"] = reason
        return cell
    t0 = perf_counter()
    try:
        c = count_cell(cfg, shape, multi_pod=multi_pod)
        cell.update(
            status="ok",
            strategy=GATHERED,
            rank=0,
            count_wall_s=round(perf_counter() - t0, 2),
            flops_per_device=float(c.flops),
            bytes_per_device=float(c.bytes),
            argument_bytes=c.argument_bytes,
            output_bytes=c.output_bytes,
            temp_bytes=c.temp_bytes,
            peak_bytes=c.peak_bytes,
            hbm_bytes=HBM_BYTES,
            fits=c.peak_bytes <= HBM_BYTES,
            collective_ops=c.collective_ops,
            collective_operand_bytes=c.collective_operand_bytes,
            collective_wire_bytes=float(c.collective_wire_bytes),
        )
        print(  # reprolint: disable=R008 the dry run's console output
            f"[ok] {arch} × {shape_name} × {mesh_name}: count {cell['count_wall_s']}s  "
            f"flops/dev {c.flops:.3e}  args {c.argument_bytes / 2**30:.2f}GiB  "
            f"temp {c.temp_bytes / 2**30:.2f}GiB  fits {cell['fits']}  "
            f"coll {c.collective_wire_bytes / 2**20:.1f}MiB", flush=True)
    except Exception as e:  # noqa: BLE001 — record and continue the sweep
        cell["status"] = "error"
        cell["error"] = f"{type(e).__name__}: {e}"
        traceback.print_exc()
    finally:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_name}.json"), "w") as f:
            json.dump(cell, f, indent=1)
    return cell


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--arch", default=None, help="one arch (default: all)")
    parser.add_argument("--shape", default=None, help="one shape (default: all)")
    parser.add_argument("--mesh", default="both", choices=("single", "multi", "both"))
    parser.add_argument("--out", default=os.path.abspath(RESULTS_DEFAULT))
    args = parser.parse_args(argv)

    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else [s.name for s in SHAPES]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    summary = {"ok": 0, "skipped": 0, "error": 0}
    t0 = perf_counter()
    for arch in archs:
        for shape_name in shapes:
            for multi in meshes:
                cell = run_cell(arch, shape_name, multi, args.out)
                summary[cell["status"]] += 1
                if cell["status"] == "skipped":
                    print(f"[skip] {arch} × {shape_name}: {cell['reason']}")  # reprolint: disable=R008 the dry run's console output
                elif cell["status"] == "error":
                    print(f"[ERR] {arch} × {shape_name}: {cell['error']}")  # reprolint: disable=R008 the dry run's console output
    print(f"\nsummary: {summary}  wall={perf_counter() - t0:.0f}s")  # reprolint: disable=R008 the dry run's console output
    if summary["error"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
