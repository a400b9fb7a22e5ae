"""Checks the model kernels' wrappers share (device and dtype), and the
dry run's count of what each kernel does.

The float kernels (RMSNorm, decode and flash attention) take float32 or
bfloat16 tensors; :data:`DTYPES` maps each to the code their C entry
points take.

Counting.  Inside :func:`counting` (the dry run's scope,
:mod:`repro_torch.launch.dryrun`) each model kernel's wrapper (K4-K7)
adds its operation and byte counts, functions of the shapes alone
(each kernel module's ``op_count`` / ``byte_count``), to the innermost
:class:`KernelCounts`, on whatever device it runs:

- a CUDA tensor still launches the kernel and nothing else, and the
  counts are added after the launch;
- a ``meta`` tensor, which the wrappers take only inside the scope
  (:func:`check_device` refuses it outside), gets the kernel's shape
  rule: empty outputs (and scratch) of the shapes, dtypes and strides
  the launch would allocate, after the checks the launch makes; the
  plain version is never called;
- a CPU tensor takes the plain version, as always, but under
  :func:`uncounted`, so the dispatch-level counters of the scope
  (``FlopCounterMode``, the dry run's byte and memory counters) see the
  kernel's own counts and not the plain version's operations; its
  result is copied, unseen too, into the outputs (and scratch) the
  launch would allocate, made in the counters' sight.

So a step counts the same on ``meta``, on the CPU and on the card.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator

import torch
from torch.utils._python_dispatch import _disable_current_modes

__all__ = [
    "DTYPES",
    "H100_SMS",
    "KernelCounts",
    "active",
    "check_device",
    "check_dtype",
    "count",
    "counting",
    "uncounted",
]

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
H100_SMS = 132  # the SM count the count rules plan launches for (an H100 SXM)


@dataclasses.dataclass
class KernelCounts:
    """Per kernel name: ``calls``, ``ops`` (operations) and ``bytes``
    (device-memory bytes moved), summed over the calls in the scope."""

    by_kernel: dict = dataclasses.field(default_factory=dict)

    def add(self, name: str, ops: int, nbytes: int) -> None:
        row = self.by_kernel.setdefault(name, {"calls": 0, "ops": 0, "bytes": 0})
        row["calls"] += 1
        row["ops"] += int(ops)
        row["bytes"] += int(nbytes)

    @property
    def ops(self) -> int:
        return sum(r["ops"] for r in self.by_kernel.values())

    @property
    def bytes(self) -> int:
        return sum(r["bytes"] for r in self.by_kernel.values())


_SCOPES: list[KernelCounts] = []  # the active counting scopes, innermost last


@contextlib.contextmanager
def counting(counts: KernelCounts | None = None) -> Iterator[KernelCounts]:
    """Scope in which the model kernels' wrappers add their counts to
    ``counts`` (a new :class:`KernelCounts` if None) and take ``meta``
    tensors; scopes nest, the innermost counts."""
    counts = KernelCounts() if counts is None else counts
    _SCOPES.append(counts)
    try:
        yield counts
    finally:
        _SCOPES.pop()


def active() -> bool:
    """Whether a :func:`counting` scope is open."""
    return bool(_SCOPES)


def count(name: str, ops: int, nbytes: int) -> None:
    """Add one call of kernel ``name`` to the innermost scope, if any."""
    if _SCOPES:
        _SCOPES[-1].add(name, ops, nbytes)


def uncounted() -> contextlib.AbstractContextManager:
    """Inside a :func:`counting` scope, suspend the active dispatch modes
    (the scope's counters) around a kernel's plain version, whose own
    operations are not the kernel's; a no-op outside one."""
    return _disable_current_modes() if _SCOPES else contextlib.nullcontext()


def check_device(name: str, *tensors: torch.Tensor) -> str:
    """The tensors' common device type: ``"cpu"``, ``"cuda"`` or, inside a
    :func:`counting` scope only, ``"meta"``; raises on a mix, on another
    device type, on ``meta`` outside the scope, and on a CUDA tensor that
    is not on the current device."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: inputs lie on different devices")
    if dev.type == "cuda":
        if dev.index != torch.cuda.current_device():
            raise ValueError(
                f"{name}: tensors on {dev} but the current device is "
                f"cuda:{torch.cuda.current_device()}"
            )
    elif dev.type == "meta":
        if not _SCOPES:
            raise ValueError(
                f"{name}: meta tensors are taken only inside a counting scope "
                f"(the dry run's); got {dev} outside one"
            )
    elif dev.type != "cpu":
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev.type


def check_dtype(name: str, *tensors: torch.Tensor) -> int:
    """The kernel's dtype code of the tensors' common dtype."""
    dtype = tensors[0].dtype
    if dtype not in DTYPES or any(t.dtype != dtype for t in tensors):
        raise TypeError(
            f"{name}: inputs must share one dtype of {sorted(map(str, DTYPES))}, "
            f"got {[str(t.dtype) for t in tensors]}"
        )
    return DTYPES[dtype]
