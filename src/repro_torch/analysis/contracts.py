"""Geometry contracts for the port's kernel entry points (the kernelcheck
registry).

The port's copy of ``repro/analysis/contracts.py``, restated for CUDA.
A :class:`KernelContract` declares, for one kernel wrapper or adapter,
the geometry lattice it must be checked over and the facts the checker
(``python -m repro_torch.analysis.kernelcheck``) proves at every lattice
point:

- ``dispatch`` — which route a geometry takes (coverage: every point,
  including past-ceiling probes, must resolve to a declared route or the
  host fallback; an exception is a coverage gap);
- ``smem`` — the :class:`BlockConfig` one block of the CUDA kernel
  launches with at that geometry: static and dynamic shared memory and
  threads, from the same function the wrapper's launcher passes to the
  launch (memory: they must fit one block's opt-in shared memory and
  the card's thread limit);
- ``ranges`` — interval claims over the declared input envelope (range:
  accumulating int32 sums and packed key fields cannot overflow);
- ``signature`` — the kernel variant a geometry selects, the port's
  counterpart of the reference's jit-cache key (variant surface: the
  sweep's distinct signatures stay bounded and fully static);
- ``abstract`` — a callable and zero-filled CPU tensors put through the
  wrapper's argument checks and its plain version (there is no
  ``jax.eval_shape``), so a shape or dtype error shows without a card.

This module is stdlib-only on purpose: the kernel modules decorate their
entry points with :func:`contract` at import time.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator

__all__ = [
    "INT32_MAX",
    "INT32_MIN",
    "Axis",
    "BlockConfig",
    "CONTRACTS",
    "Interval",
    "KernelContract",
    "RangeClaim",
    "choice",
    "contract",
    "lattice",
    "register",
    "span",
]

INT32_MIN = -(1 << 31)
INT32_MAX = (1 << 31) - 1

_DTYPE_BOUNDS = {
    "int32": (INT32_MIN, INT32_MAX),
    "int64": (-(1 << 63), (1 << 63) - 1),
}


@dataclasses.dataclass(frozen=True)
class Interval:
    """Closed integer interval ``[lo, hi]`` with conservative arithmetic."""

    lo: int
    hi: int

    def __post_init__(self) -> None:
        if self.lo > self.hi:
            raise ValueError(f"empty interval [{self.lo}, {self.hi}]")

    @staticmethod
    def const(value: int) -> "Interval":
        return Interval(value, value)

    @staticmethod
    def _coerce(value: "Interval | int") -> "Interval":
        return value if isinstance(value, Interval) else Interval.const(int(value))

    def __add__(self, other: "Interval | int") -> "Interval":
        o = Interval._coerce(other)
        return Interval(self.lo + o.lo, self.hi + o.hi)

    __radd__ = __add__

    def __neg__(self) -> "Interval":
        return Interval(-self.hi, -self.lo)

    def __sub__(self, other: "Interval | int") -> "Interval":
        return self + (-Interval._coerce(other))

    def __rsub__(self, other: "Interval | int") -> "Interval":
        return Interval._coerce(other) + (-self)

    def __mul__(self, other: "Interval | int") -> "Interval":
        o = Interval._coerce(other)
        corners = (
            self.lo * o.lo,
            self.lo * o.hi,
            self.hi * o.lo,
            self.hi * o.hi,
        )
        return Interval(min(corners), max(corners))

    __rmul__ = __mul__

    def __lshift__(self, bits: int) -> "Interval":
        if self.lo < 0:
            raise ValueError("left shift of a possibly-negative interval")
        return Interval(self.lo << bits, self.hi << bits)

    def __or__(self, other: "Interval | int") -> "Interval":
        # Bit-packing bound: for non-negative a, b we have
        # max(a, b) <= a | b <= a + b, which is exact for disjoint fields.
        o = Interval._coerce(other)
        if self.lo < 0 or o.lo < 0:
            raise ValueError("bitwise-or bound requires non-negative intervals")
        return Interval(max(self.lo, o.lo), self.hi + o.hi)


@dataclasses.dataclass(frozen=True)
class RangeClaim:
    """One overflow/ordering claim the range check validates.

    ``dtype`` asserts the interval fits the dtype; ``bits`` asserts it fits
    an unsigned bit-field of that width (e.g. a 15-bit packed server id);
    ``bound`` asserts ``value.hi <= bound`` (envelope preservation, e.g.
    "the evolved busy vector still satisfies the kernel's precondition");
    ``positive`` asserts ``value.lo > 0`` (sentinel-headroom ordering).
    """

    name: str
    value: Interval
    dtype: str | None = "int32"
    bits: int | None = None
    bound: int | None = None
    positive: bool = False

    def check(self) -> str | None:
        v = self.value
        if self.dtype is not None:
            lo, hi = _DTYPE_BOUNDS[self.dtype]
            if v.lo < lo or v.hi > hi:
                return (
                    f"{self.name}: interval [{v.lo}, {v.hi}] exceeds "
                    f"{self.dtype} [{lo}, {hi}]"
                )
        if self.bits is not None and (v.lo < 0 or v.hi >= (1 << self.bits)):
            return (
                f"{self.name}: interval [{v.lo}, {v.hi}] does not fit an "
                f"unsigned {self.bits}-bit field"
            )
        if self.bound is not None and v.hi > self.bound:
            return (
                f"{self.name}: interval high {v.hi} exceeds declared "
                f"bound {self.bound}"
            )
        if self.positive and v.lo <= 0:
            return f"{self.name}: interval low {v.lo} is not strictly positive"
        return None


@dataclasses.dataclass(frozen=True)
class BlockConfig:
    """What one block of a CUDA kernel takes at launch: static shared
    memory (the kernel's ``__shared__`` variables), dynamic shared memory
    (the launch's third parameter) and threads."""

    static_smem: int
    dynamic_smem: int
    threads: int

    @property
    def smem_bytes(self) -> int:
        return self.static_smem + self.dynamic_smem


@dataclasses.dataclass(frozen=True)
class Axis:
    """One lattice axis: admissible ``points`` plus ``past``-ceiling probes.

    ``past`` values lie beyond the entry point's declared admissible range;
    the coverage check still requires dispatch to resolve them (to the
    plain or host fallback), but range/memory/signature claims are not
    evaluated there.
    """

    name: str
    points: tuple[Any, ...]
    past: tuple[Any, ...] = ()

    def __post_init__(self) -> None:
        if not self.points:
            raise ValueError(f"axis {self.name!r} has no lattice points")


def span(
    name: str,
    lo: int,
    hi: int,
    *,
    boundaries: tuple[int, ...] = (),
    past: tuple[int, ...] = (),
) -> Axis:
    """Boundary-focused integer axis: endpoints plus ``b - 1, b, b + 1``
    around every declared boundary, clipped to ``[lo, hi]``."""
    pts = {lo, hi}
    for b in boundaries:
        pts.update(v for v in (b - 1, b, b + 1) if lo <= v <= hi)
    return Axis(name, tuple(sorted(pts)), tuple(sorted(past)))


def choice(name: str, *values: Any) -> Axis:
    """Categorical axis (requested route, device, burst sizes, ...)."""
    return Axis(name, values)


@dataclasses.dataclass(frozen=True)
class KernelContract:
    """Declared geometry contract for one device entry point."""

    name: str
    entry: str  # dotted qualname of the decorated callable (for the report)
    module: str  # defining module; the checker selects contracts by module
    axes: tuple[Axis, ...]
    backends: tuple[str, ...]  # every route dispatch may legally return
    device_backends: tuple[str, ...]  # subset that launches the CUDA kernel
    dispatch: Callable[[dict[str, Any]], str]
    smem: Callable[[dict[str, Any]], BlockConfig] | None = None
    ranges: Callable[[dict[str, Any]], list[RangeClaim]] | None = None
    signature: Callable[[dict[str, Any]], tuple] | None = None
    max_signatures: int | None = None
    abstract: Callable[[dict[str, Any]], tuple[Callable, tuple]] | None = None
    eval_points: int = 4  # admissible device points run through ``abstract``
    notes: str = ""


CONTRACTS: dict[str, KernelContract] = {}


def register(c: KernelContract) -> None:
    existing = CONTRACTS.get(c.name)
    if existing is not None and existing.entry != c.entry:
        raise ValueError(
            f"kernelcheck contract {c.name!r} already registered for "
            f"{existing.entry} (attempted re-registration from {c.entry})"
        )
    CONTRACTS[c.name] = c


def contract(
    name: str,
    *,
    axes: tuple[Axis, ...],
    backends: tuple[str, ...],
    dispatch: Callable[[dict[str, Any]], str],
    device_backends: tuple[str, ...] | None = None,
    smem: Callable[[dict[str, Any]], BlockConfig] | None = None,
    ranges: Callable[[dict[str, Any]], list[RangeClaim]] | None = None,
    signature: Callable[[dict[str, Any]], tuple] | None = None,
    max_signatures: int | None = None,
    abstract: Callable[[dict[str, Any]], tuple[Callable, tuple]] | None = None,
    eval_points: int = 4,
    notes: str = "",
) -> Callable:
    """Decorator: register a :class:`KernelContract` for the wrapped entry
    point and return the entry point unchanged (zero runtime overhead)."""

    def deco(fn: Callable) -> Callable:
        register(
            KernelContract(
                name=name,
                entry=f"{fn.__module__}.{fn.__qualname__}",
                module=fn.__module__,
                axes=axes,
                backends=backends,
                device_backends=(
                    backends if device_backends is None else device_backends
                ),
                dispatch=dispatch,
                smem=smem,
                ranges=ranges,
                signature=signature,
                max_signatures=max_signatures,
                abstract=abstract,
                eval_points=eval_points,
                notes=notes,
            )
        )
        return fn

    return deco


def lattice(c: KernelContract) -> Iterator[tuple[dict[str, Any], bool]]:
    """Yield ``(geometry, admissible)`` over the full product lattice.

    A geometry is admissible when every component is an in-range point;
    any ``past`` component makes the point a coverage-only probe.
    """
    axes = c.axes

    def rec(i: int, geom: dict[str, Any], admissible: bool) -> Iterator[tuple[dict[str, Any], bool]]:
        if i == len(axes):
            yield dict(geom), admissible
            return
        ax = axes[i]
        for v in ax.points:
            geom[ax.name] = v
            yield from rec(i + 1, geom, admissible)
        for v in ax.past:
            geom[ax.name] = v
            yield from rec(i + 1, geom, False)
        geom.pop(ax.name, None)

    yield from rec(0, {}, True)
