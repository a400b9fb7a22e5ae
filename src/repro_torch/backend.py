"""The port's one config object for backend and device choices.

- :func:`resolve` returns the configured backend for a kind
  (``"waterlevel"`` → ``auto|cuda|torch``) with the precedence
  explicit argument > :func:`set_backend` scope > ``"auto"``;
- :func:`device` returns the device the entry points place their
  tensors on: the innermost ``set_backend(device=...)`` scope, else
  ``cuda``.  There is no silent CPU default: on a machine without a GPU
  an entry point called outside a ``device="cpu"`` scope fails inside
  torch when it first places a tensor;
- :func:`set_backend` scopes explicit choices
  (``with set_backend(waterlevel="torch", device="cpu"): ...``); scopes
  nest and restore on exit.

``auto`` is returned verbatim: mapping it to a concrete path (the CUDA
kernel up to its lane ceiling, the plain torch pipeline past it) is the
consumer's job (:func:`repro_torch.kernels.waterlevel.resolve_waterlevel`).
Nothing here reads the environment.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator

import torch

__all__ = [
    "BACKEND_KINDS",
    "BackendConfig",
    "current",
    "device",
    "resolve",
    "set_backend",
]

# kind -> valid choices
BACKEND_KINDS: dict[str, tuple[str, ...]] = {
    "waterlevel": ("auto", "cuda", "torch"),
}

DEFAULT_DEVICE = "cuda"


@dataclasses.dataclass(frozen=True)
class BackendConfig:
    """Explicit choices; ``None`` means "not set here" (fall through to
    ``auto``, or to :data:`DEFAULT_DEVICE` for the device)."""

    waterlevel: str | None = None
    device: str | None = None

    def __post_init__(self) -> None:
        for kind in BACKEND_KINDS:
            choice = getattr(self, kind)
            if choice is not None:
                _check(kind, choice, source="set_backend")
        if self.device is not None:
            torch.device(self.device)  # raises on a malformed device string


def _check(kind: str, choice: str, *, source: str) -> str:
    valid = BACKEND_KINDS[_check_kind(kind)]
    if choice not in valid:
        raise ValueError(
            f"{source}: {kind} backend {choice!r}: expected one of {valid}"
        )
    return choice


def _check_kind(kind: str) -> str:
    if kind not in BACKEND_KINDS:
        raise KeyError(
            f"unknown backend kind {kind!r}; known: {sorted(BACKEND_KINDS)}"
        )
    return kind


_stack: list[BackendConfig] = [BackendConfig()]


def current() -> BackendConfig:
    """The innermost active config."""
    return _stack[-1]


def resolve(kind: str, explicit: str | None = None) -> str:
    """The backend for ``kind``: explicit argument > :func:`set_backend`
    scope > ``"auto"``."""
    if explicit is not None:
        return _check(kind, explicit, source="explicit backend")
    configured = getattr(current(), _check_kind(kind))
    return "auto" if configured is None else configured


def device() -> torch.device:
    """The device entry points allocate on (``cuda`` unless scoped)."""
    return torch.device(current().device or DEFAULT_DEVICE)


@contextlib.contextmanager
def set_backend(**choices: str) -> Iterator[BackendConfig]:
    """Scope explicit choices, e.g.::

        with set_backend(waterlevel="torch", device="cpu"):
            engine.run(jobs)

    Nested scopes override only what they name.  Choices are validated
    at entry (unknown kinds and invalid names raise immediately).
    """
    for kind in choices:
        if kind != "device":
            _check_kind(kind)
    cfg = dataclasses.replace(current(), **choices)
    _stack.append(cfg)
    try:
        yield cfg
    finally:
        _stack.pop()
