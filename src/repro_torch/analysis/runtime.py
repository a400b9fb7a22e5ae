"""Runtime sanitizers: the dynamic complement to the reprolint rules.

The port's copy of ``repro/analysis/runtime.py``.  Two invariants are
only checkable while the system runs:

- **buffer aliasing into async dispatch** (R001's dynamic twin).  A
  host buffer handed to an asynchronous device call must not be
  mutated in place before the call completes — or, equivalently, the
  value the computation reads must equal the value at handoff.  In
  torch, ``torch.from_numpy`` (and ``torch.as_tensor`` of a numpy array
  on the CPU) shares the array's memory: the zero-copy alias that the
  reference once made of a live decode-position buffer.
  :class:`BufferGuard` snapshots the buffer at handoff and re-reads the
  device value at the next sync point; any divergence means an in-place
  mutation leaked through an alias.  ``ServeEngine(debug=True)`` arms
  one around every decode step.

- **event-heap ordering** (R004's dynamic twin).  The control plane's
  determinism rests on the ``(t, prio, seq)`` heap keys being a *total*
  order — unique prefixes, comparable types, heap property intact — so
  ``heapq`` never falls through to comparing payloads (which would
  raise, or worse, order events by object identity).
  :func:`check_event_heap` asserts all three every tick.

Sanitizers run when the owning object was built with ``debug=True`` or
when :func:`enable` has switched them on process-wide (a global toggle;
nothing reads the environment).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "SanitizerError",
    "BufferGuard",
    "check_event_heap",
    "enable",
    "disable",
    "enabled",
]


class SanitizerError(AssertionError):
    """An invariant the sanitizers watch was violated at runtime."""


_ENABLED = False


def enable() -> None:
    """Switch sanitizers on process-wide (every ``ControlPlane`` built
    afterwards behaves as if ``debug=True``)."""
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def enabled() -> bool:
    return _ENABLED


def _as_numpy(value) -> np.ndarray:
    """A tensor's values as numpy (a view of a CPU tensor, so sharing
    with the host buffer stays visible; a copy from the card); other
    array-likes through ``np.asarray``."""
    if hasattr(value, "detach"):
        return value.detach().cpu().numpy()
    return np.asarray(value)


class BufferGuard:
    """Watch host buffers handed to asynchronous device calls for
    in-place mutation visible to the dispatched computation.

    Usage, at a device entry point::

        dev = torch.tensor(self._pos)       # must copy — that's the point
        guard.capture("pos", self._pos, dev)
        ... launch, host-side bookkeeping (may mutate self._pos) ...
        guard.verify()                       # at the next sync point

    ``capture`` snapshots the host buffer and detects outright memory
    sharing between the host buffer and a CPU tensor (``from_numpy``
    shares it), so the alias is caught at handoff even before any
    mutation.  ``verify`` re-reads each captured device value and raises
    :class:`SanitizerError` if it no longer equals the handoff snapshot:
    the only way that happens is an in-place host mutation that leaked
    through an alias into the dispatched computation.
    """

    def __init__(self) -> None:
        self._captures: list[tuple[str, np.ndarray, object]] = []

    def capture(self, label: str, host, device_value) -> None:
        host_arr = np.asarray(host)
        snapshot = host_arr.copy()
        if np.shares_memory(_as_numpy(device_value), host_arr):
            raise SanitizerError(
                f"buffer {label!r} handed to a device call aliases the "
                f"live host buffer (zero-copy) — in-place host mutation "
                f"will be visible to the async launch; copy first "
                f"(torch.tensor, not torch.from_numpy)"
            )
        self._captures.append((label, snapshot, device_value))

    def verify(self) -> None:
        """Assert every captured device value still equals its handoff
        snapshot; clears the capture list either way."""
        captures, self._captures = self._captures, []
        for label, snapshot, device_value in captures:
            got = _as_numpy(device_value)
            if got.shape != snapshot.shape or not np.array_equal(got, snapshot):
                raise SanitizerError(
                    f"buffer {label!r} changed between handoff and "
                    f"completion ({snapshot.tolist()} -> {got.tolist()}) — "
                    f"an in-place mutation leaked through an alias into "
                    f"the async computation"
                )

    def __len__(self) -> int:
        return len(self._captures)


def check_event_heap(heap: list) -> None:
    """Assert the control-plane heap invariant on ``heap`` (a ``heapq``
    list of ``(t, prio, seq, payload)`` tuples):

    - every entry is a tuple with an integer ``(t, prio, seq)`` prefix
      (comparable keys — heapq must never reach the payload),
    - ``(t, prio, seq)`` prefixes are unique (``seq`` makes the order
      total, so ties can never fall through to payload comparison),
    - the heap property holds on the prefixes.
    """
    seen: set[tuple[int, int, int]] = set()
    for i, entry in enumerate(heap):
        if not isinstance(entry, tuple) or len(entry) < 3:
            raise SanitizerError(
                f"event heap entry {i} is not a (t, prio, seq, ...) "
                f"tuple: {entry!r}"
            )
        key = entry[:3]
        for part in key:
            if not isinstance(part, (int, np.integer)):
                raise SanitizerError(
                    f"event heap entry {i} has a non-integer key part "
                    f"{part!r} in {key!r} — (t, prio, seq) must stay a "
                    f"totally ordered integer triple"
                )
        key = (int(key[0]), int(key[1]), int(key[2]))
        if key in seen:
            raise SanitizerError(
                f"duplicate event-heap key {key}: seq must be unique or "
                f"heapq falls through to comparing payloads"
            )
        seen.add(key)
    n = len(heap)
    for i in range(n):
        for child in (2 * i + 1, 2 * i + 2):
            if child < n and heap[i][:3] > heap[child][:3]:
                raise SanitizerError(
                    f"event-heap property violated at index {i}: "
                    f"{heap[i][:3]} > child {heap[child][:3]} — was the "
                    f"heap mutated without heapq?"
                )
