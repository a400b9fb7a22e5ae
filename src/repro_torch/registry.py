"""One name→implementation registry for every pluggable axis of the port.

The port's counterpart of ``repro/registry.py``, kept as its own copy so
that ``repro_torch`` imports nothing of ``repro``.  Implementations
register under a *kind* (``"algorithm"``, ``"batch_algorithm"``,
``"scenario"``, ``"ordering"``) and a name, and every lookup resolves
through :func:`resolve`.  The module-level views
(``repro_torch.core.ALGORITHMS`` and friends) are the registry's own
storage: ``ALGORITHMS is kind_dict("algorithm")``.

Usage::

    from repro_torch import registry

    @registry.register("algorithm", "my_heuristic")
    def my_heuristic(problem): ...

    assign = registry.resolve("algorithm", "my_heuristic")
    registry.names("algorithm")   # ['my_heuristic', 'wf', 'wf_torch']

This module stays dependency-free (no torch, no numpy, nothing else of
the package) so every subsystem can import it without cycles.
"""

from __future__ import annotations

from typing import Any, Callable, TypeVar

__all__ = ["register", "resolve", "names", "kinds", "kind_dict", "contains"]

T = TypeVar("T")

_SENTINEL = object()

_REGISTRIES: dict[str, dict[str, Any]] = {}


def kind_dict(kind: str) -> dict[str, Any]:
    """The live name→value mapping for ``kind`` (created on first use)."""
    return _REGISTRIES.setdefault(kind, {})


def register(
    kind: str, name: str, value: Any = _SENTINEL, *, overwrite: bool = False
) -> Callable[[T], T] | Any:
    """Register ``value`` under ``(kind, name)``.

    With ``value`` omitted, returns a decorator.  Re-registering a name
    raises unless ``overwrite=True`` (or the value is identical —
    idempotent re-imports are fine).
    """
    reg = kind_dict(kind)

    def _put(v: T) -> T:
        if not overwrite and name in reg and reg[name] is not v:
            raise ValueError(
                f"{kind} {name!r} already registered; pass overwrite=True "
                f"to replace it"
            )
        reg[name] = v
        return v

    if value is _SENTINEL:
        return _put
    return _put(value)


def resolve(kind: str, name: str) -> Any:
    """Look up ``name`` within ``kind``; raises KeyError listing what is
    registered."""
    reg = _REGISTRIES.get(kind)
    if not reg:
        raise KeyError(
            f"no {kind!r} registry (known kinds: {sorted(_REGISTRIES)})"
        )
    try:
        return reg[name]
    except KeyError:
        raise KeyError(
            f"unknown {kind} {name!r}; registered: {sorted(reg)}"
        ) from None


def contains(kind: str, name: str) -> bool:
    return name in _REGISTRIES.get(kind, {})


def names(kind: str) -> list[str]:
    """Sorted names registered under ``kind``."""
    return sorted(_REGISTRIES.get(kind, {}))


def kinds() -> list[str]:
    return sorted(_REGISTRIES)
