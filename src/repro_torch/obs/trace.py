"""Typed span/instant trace events in a fixed-capacity ring buffer.

The port's copy of ``repro/obs/trace.py`` (numpy and the stdlib only),
so that a trace of the port and one of the reference compare record for
record.

:class:`TraceRecorder` stores every event as one row of seven int64
columns — ``(kind, ts, dur, a, b, c, link)`` — in preallocated numpy
arrays, overwriting the oldest rows once ``capacity`` is exceeded
(:attr:`TraceRecorder.dropped` counts the overwritten rows).  Strings
(placement blocks, device-dispatch signatures, tick-phase names) are
interned to small integers so the hot recording path never formats or
hashes anything larger than a tuple.

Two exports:

- :meth:`TraceRecorder.to_table` — the columns as numpy arrays plus the
  intern table, for direct analysis;
- :meth:`TraceRecorder.to_chrome_trace` — Chrome/Perfetto
  ``trace_event`` JSON (open at https://ui.perfetto.dev).  Sim-time
  events render at :data:`SLOT_US` microseconds per scheduler slot;
  host-time events (tick phases, device dispatches) use real
  microseconds since the session started.  Steal/speculation causality
  is emitted as flow-event pairs (``ph: "s"``/``"f"``) binding the job's
  lifecycle span to the slice on the server that picked the work up.

Every record's primary JSON event carries the canonical seven-tuple in
``args``, so :func:`parse_chrome_trace` round-trips a trace exactly —
the contract ``tests/test_torch_obs.py`` pins.

Field use per kind (unused fields are 0):

==================  ====  =======================  ==========================
kind                time  ts / dur                 a / b / c / link
==================  ====  =======================  ==========================
SPAN_JOB            sim   arrival slot / jct       job / - / n_tasks / -
INST_ARRIVAL        sim   slot / -                 job / - / n_tasks / -
INST_ADMIT          sim   slot / -                 job / - / overhead ns / -
INST_FIRST_SERVICE  sim   slot / -                 job / - / - / -
INST_FAILED         sim   slot / -                 job / - / - / -
INST_REASSIGN       sim   slot / -                 job / - / tasks / -
INST_STEAL          sim   slot / thief             job / donor / tasks / flow
INST_SPEC_LAUNCH    sim   slot / -                 job / src / dst / flow
INST_SPEC_RESOLVE   sim   slot / -                 job / winner / tasks / flow
INST_PLACEMENT      sim   slot / -                 str / server / - / -
SPAN_SERVE          sim   submit slot / latency    rid / - / tokens / -
SPAN_TICK           host  start us / wall us       str(phase) / - / - / -
INST_DEVICE         host  start us / wall us       str(sig) / flags / ns / -
==================  ====  =======================  ==========================

``INST_SPEC_RESOLVE.b``: 0 = original copy won, 1 = clone won, 2 = pair
aborted before completion.  ``INST_DEVICE.b``: bit 0 = jit-cache miss
(compile included in the wall time), bit 1 = host fallback taken.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "SLOT_US",
    "KIND_NAMES",
    "TraceRecorder",
    "parse_chrome_trace",
]

# one scheduler slot renders as 1 ms so Perfetto's zoom levels are usable
SLOT_US = 1000

SPAN_JOB = 1
INST_ARRIVAL = 2
INST_ADMIT = 3
INST_FIRST_SERVICE = 4
INST_FAILED = 5
INST_REASSIGN = 6
INST_STEAL = 7
INST_SPEC_LAUNCH = 8
INST_SPEC_RESOLVE = 9
INST_PLACEMENT = 10
SPAN_SERVE = 11
SPAN_TICK = 12
INST_DEVICE = 13

KIND_NAMES: dict[int, str] = {
    SPAN_JOB: "job",
    INST_ARRIVAL: "arrival",
    INST_ADMIT: "admit",
    INST_FIRST_SERVICE: "first-service",
    INST_FAILED: "failed",
    INST_REASSIGN: "reassign",
    INST_STEAL: "steal",
    INST_SPEC_LAUNCH: "spec-launch",
    INST_SPEC_RESOLVE: "spec-resolve",
    INST_PLACEMENT: "placement",
    SPAN_SERVE: "serve",
    SPAN_TICK: "tick",
    INST_DEVICE: "device",
}

# Perfetto "process" ids grouping the tracks
_PID_JOBS = 0
_PID_SERVERS = 1
_PID_HOST = 2
_PID_SERVE = 3
_PID_DEVICE = 4

_HOST_TIME_KINDS = frozenset((SPAN_TICK, INST_DEVICE))

_FIELDS = ("kind", "ts", "dur", "a", "b", "c", "link")


class TraceRecorder:
    """Ring buffer of typed trace events (columnar, fixed capacity)."""

    def __init__(self, capacity: int = 1 << 16):
        capacity = int(capacity)
        if capacity <= 0:
            raise ValueError(f"trace capacity must be positive, got {capacity}")
        self._cap = capacity
        self._cols = {f: np.zeros(capacity, dtype=np.int64) for f in _FIELDS}
        self._n = 0
        self._strings: list[str] = []
        self._string_ids: dict[str, int] = {}

    # ---- recording -------------------------------------------------------

    def intern(self, s: str) -> int:
        sid = self._string_ids.get(s)
        if sid is None:
            sid = len(self._strings)
            self._string_ids[s] = sid
            self._strings.append(s)
        return sid

    def record(
        self,
        kind: int,
        ts: int,
        dur: int = 0,
        a: int = 0,
        b: int = 0,
        c: int = 0,
        link: int = 0,
    ) -> None:
        i = self._n % self._cap
        cols = self._cols
        cols["kind"][i] = kind
        cols["ts"][i] = ts
        cols["dur"][i] = dur
        cols["a"][i] = a
        cols["b"][i] = b
        cols["c"][i] = c
        cols["link"][i] = link
        self._n += 1

    # ---- introspection ---------------------------------------------------

    def __len__(self) -> int:
        return min(self._n, self._cap)

    @property
    def capacity(self) -> int:
        return self._cap

    @property
    def total(self) -> int:
        """Events ever recorded (including overwritten ones)."""
        return self._n

    @property
    def dropped(self) -> int:
        """Events overwritten by ring wraparound."""
        return max(0, self._n - self._cap)

    @property
    def strings(self) -> tuple[str, ...]:
        return tuple(self._strings)

    def _order(self) -> np.ndarray:
        """Row indices oldest → newest."""
        n = len(self)
        if self._n <= self._cap:
            return np.arange(n)
        head = self._n % self._cap
        return np.concatenate([np.arange(head, self._cap), np.arange(head)])

    def records(self) -> list[tuple[int, int, int, int, int, int, int]]:
        """Canonical event tuples, oldest first — the round-trip unit."""
        order = self._order()
        cols = [self._cols[f][order] for f in _FIELDS]
        return [tuple(int(col[i]) for col in cols) for i in range(len(order))]

    def to_table(self) -> dict[str, np.ndarray]:
        """Columnar copy (oldest first) plus the intern table under
        ``"strings"`` (dtype ``str_``)."""
        order = self._order()
        out = {f: self._cols[f][order].copy() for f in _FIELDS}
        out["strings"] = np.asarray(self._strings, dtype=np.str_)
        return out

    # ---- Chrome trace_event export ---------------------------------------

    def _name(self, sid: int) -> str:
        return self._strings[sid] if 0 <= sid < len(self._strings) else f"?{sid}"

    def to_chrome_trace(self) -> dict:
        """The trace as a Chrome ``trace_event`` JSON object (dict).

        ``json.dump`` the result and open it at https://ui.perfetto.dev
        (or chrome://tracing).  The canonical tuple of every record rides
        in its primary event's ``args`` — see :func:`parse_chrome_trace`.
        """
        events: list[dict] = []
        for pid, name in (
            (_PID_JOBS, "jobs (1 slot = 1 ms)"),
            (_PID_SERVERS, "servers (1 slot = 1 ms)"),
            (_PID_HOST, "control plane (host time)"),
            (_PID_SERVE, "serve requests (1 slot = 1 ms)"),
            (_PID_DEVICE, "device dispatch (host time)"),
        ):
            events.append(
                {
                    "ph": "M",
                    "name": "process_name",
                    "pid": pid,
                    "tid": 0,
                    "args": {"name": name},
                }
            )
        named_tids: set[tuple[int, int]] = set()

        def thread_name(pid: int, tid: int, name: str) -> None:
            if (pid, tid) not in named_tids:
                named_tids.add((pid, tid))
                events.append(
                    {
                        "ph": "M",
                        "name": "thread_name",
                        "pid": pid,
                        "tid": tid,
                        "args": {"name": name},
                    }
                )

        spec_launch: dict[int, tuple] = {}  # flow id -> launch record
        for rec in self.records():
            kind, ts, dur, a, b, c, link = rec
            args = dict(zip(_FIELDS, rec))
            kname = KIND_NAMES.get(kind, f"kind-{kind}")
            if kind == SPAN_JOB:
                thread_name(_PID_JOBS, a, f"job {a}")
                events.append(
                    {
                        "ph": "X",
                        "name": f"job {a}",
                        "cat": "job",
                        "pid": _PID_JOBS,
                        "tid": a,
                        "ts": ts * SLOT_US,
                        "dur": max(dur, 1) * SLOT_US,
                        "args": args,
                    }
                )
            elif kind == SPAN_SERVE:
                events.append(
                    {
                        "ph": "X",
                        "name": f"req {a}",
                        "cat": "serve",
                        "pid": _PID_SERVE,
                        "tid": a,
                        "ts": ts * SLOT_US,
                        "dur": max(dur, 1) * SLOT_US,
                        "args": args,
                    }
                )
            elif kind == SPAN_TICK:
                thread_name(_PID_HOST, a, self._name(a))
                events.append(
                    {
                        "ph": "X",
                        "name": self._name(a),
                        "cat": "tick",
                        "pid": _PID_HOST,
                        "tid": a,
                        "ts": ts,
                        "dur": max(dur, 1),
                        "args": args,
                    }
                )
            elif kind == INST_DEVICE:
                thread_name(_PID_DEVICE, a, self._name(a))
                events.append(
                    {
                        "ph": "X",
                        "name": self._name(a),
                        "cat": "device",
                        "pid": _PID_DEVICE,
                        "tid": a,
                        "ts": ts,
                        "dur": max(dur, 1),
                        "args": dict(
                            args, cache_miss=bool(b & 1), host_fallback=bool(b & 2)
                        ),
                    }
                )
            elif kind == INST_STEAL:
                # primary instant on the victim job's track ...
                events.append(
                    {
                        "ph": "i",
                        "s": "t",
                        "name": "steal",
                        "cat": "steal",
                        "pid": _PID_JOBS,
                        "tid": a,
                        "ts": ts * SLOT_US,
                        "args": args,
                    }
                )
                # ... a slice on the thief server's track (dur is the thief)
                thief = dur
                thread_name(_PID_SERVERS, thief, f"server {thief}")
                events.append(
                    {
                        "ph": "X",
                        "name": f"steal job {a} ({c} tasks)",
                        "cat": "steal",
                        "pid": _PID_SERVERS,
                        "tid": thief,
                        "ts": ts * SLOT_US,
                        "dur": SLOT_US,
                        "args": {},
                    }
                )
                # ... and the causality link: job span -> thief slice
                events.append(
                    {
                        "ph": "s",
                        "name": "steal",
                        "cat": "steal",
                        "id": link,
                        "pid": _PID_JOBS,
                        "tid": a,
                        "ts": ts * SLOT_US,
                    }
                )
                events.append(
                    {
                        "ph": "f",
                        "bp": "e",
                        "name": "steal",
                        "cat": "steal",
                        "id": link,
                        "pid": _PID_SERVERS,
                        "tid": thief,
                        "ts": ts * SLOT_US,
                    }
                )
            elif kind == INST_SPEC_LAUNCH:
                events.append(
                    {
                        "ph": "i",
                        "s": "t",
                        "name": "spec-launch",
                        "cat": "spec",
                        "pid": _PID_JOBS,
                        "tid": a,
                        "ts": ts * SLOT_US,
                        "args": args,
                    }
                )
                events.append(
                    {
                        "ph": "s",
                        "name": "spec",
                        "cat": "spec",
                        "id": link,
                        "pid": _PID_JOBS,
                        "tid": a,
                        "ts": ts * SLOT_US,
                    }
                )
                spec_launch[link] = rec
            elif kind == INST_SPEC_RESOLVE:
                events.append(
                    {
                        "ph": "i",
                        "s": "t",
                        "name": "spec-resolve",
                        "cat": "spec",
                        "pid": _PID_JOBS,
                        "tid": a,
                        "ts": ts * SLOT_US,
                        "args": args,
                    }
                )
                launch = spec_launch.pop(link, None)
                if launch is not None:
                    l_ts, dst = launch[1], launch[5]
                    outcome = ("lost", "won", "aborted")[min(b, 2)]
                    thread_name(_PID_SERVERS, dst, f"server {dst}")
                    events.append(
                        {
                            "ph": "X",
                            "name": f"spec job {a} ({outcome})",
                            "cat": "spec",
                            "pid": _PID_SERVERS,
                            "tid": dst,
                            "ts": l_ts * SLOT_US,
                            "dur": max(ts - l_ts, 1) * SLOT_US,
                            "args": {},
                        }
                    )
                    events.append(
                        {
                            "ph": "f",
                            "bp": "e",
                            "name": "spec",
                            "cat": "spec",
                            "id": link,
                            "pid": _PID_SERVERS,
                            "tid": dst,
                            "ts": l_ts * SLOT_US,
                        }
                    )
            elif kind == INST_PLACEMENT:
                thread_name(_PID_SERVERS, b, f"server {b}")
                events.append(
                    {
                        "ph": "i",
                        "s": "t",
                        "name": self._name(a),
                        "cat": "placement",
                        "pid": _PID_SERVERS,
                        "tid": b,
                        "ts": ts * SLOT_US,
                        "args": args,
                    }
                )
            else:  # job-track instants: arrival/admit/first-service/failed/...
                events.append(
                    {
                        "ph": "i",
                        "s": "t",
                        "name": kname,
                        "cat": "job",
                        "pid": _PID_JOBS,
                        "tid": a,
                        "ts": ts * SLOT_US,
                        "args": args,
                    }
                )
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "generator": "repro_torch.obs",
                "slot_us": SLOT_US,
                "dropped": self.dropped,
                "strings": list(self._strings),
            },
        }


def parse_chrome_trace(payload: dict | list) -> tuple[list[tuple], list[str]]:
    """Recover ``(records, strings)`` from a Chrome trace exported by
    :meth:`TraceRecorder.to_chrome_trace` (after any ``json`` round
    trip).  Only primary events — those carrying the canonical tuple in
    ``args`` — are recovered; derived slices and flow events are
    presentation."""
    if isinstance(payload, dict):
        events = payload.get("traceEvents", [])
        strings = list(payload.get("otherData", {}).get("strings", []))
    else:
        events, strings = payload, []
    records: list[tuple] = []
    for ev in events:
        args = ev.get("args")
        if isinstance(args, dict) and "kind" in args and "link" in args:
            records.append(tuple(int(args[f]) for f in _FIELDS))
    return records, strings
