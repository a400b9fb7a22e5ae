"""Replay a real Alibaba ``cluster-trace-v2017`` segment through the engine.

The port's copy of ``repro/traces/cluster_v2017.py``: the same schema,
validation, chunked two-pass replay and jobs.  The one difference: the
CSV's path comes only from ``ClusterTraceConfig.path`` (or the ``path``
argument of :func:`trace_available`); nothing reads the environment.

The paper (Sec. V-A) extracts 250 jobs / 113,653 tasks from
``cluster-trace-v2017/batch_task.csv``: each trace *entry* (task event)
is one task group whose ``instance_num`` instances are the group's
tasks.  This loader replays the real CSV when it is available — schema
validation included — and degrades gracefully when it is not (the file
is too large to check in):

- ``ClusterTraceConfig.path`` points at a ``batch_task.csv``-shaped
  file; no path, or a missing file, raises :class:`FileNotFoundError`
  with a hint, and :func:`trace_available` lets sweeps skip the scenario
  instead of crashing;
- the CSV is the trace's published headerless 8-column schema
  (``create_timestamp, modify_timestamp, job_id, task_id, instance_num,
  status, plan_cpu, plan_mem``); a header row is tolerated, malformed
  rows raise :class:`ValueError` with the line number;
- rows are filtered to ``statuses`` (default ``Terminated``), grouped by
  ``job_id``, and become jobs under the shared placement/capacity model
  (:mod:`repro_torch.traces.placement`) — one task group per CSV row, arrival
  slot from the job's earliest ``create_timestamp``.

Reading is *chunked*: :func:`iter_batch_task_csv` yields validated row
blocks of ``chunk_rows`` instead of materializing the file, and
:func:`generate_cluster_trace` replays the CSV in two streaming passes —
pass 1 keeps only per-job earliest timestamps (O(#jobs) memory) to pick
the ``n_jobs`` arrival-order segment, pass 2 retains rows for the
selected jobs only — so the published multi-GB ``batch_task.csv`` runs
through without holding the parse in memory.  (A job's earliest
timestamp can appear anywhere in the file, so a single bounded pass
cannot pick the segment safely; two passes trade one extra scan for an
exact, OOM-free replay.)

A small fixture CSV (``tests/data/batch_task_sample.csv``) exercises the
full path — including a 2-row chunk size — in the CPU tests.
"""

from __future__ import annotations

import csv
import dataclasses
import os

import numpy as np

from ..core import Job
from .placement import build_job

__all__ = [
    "CSV_COLUMNS",
    "ClusterTraceConfig",
    "TraceRow",
    "trace_available",
    "iter_batch_task_csv",
    "load_batch_task_csv",
    "generate_cluster_trace",
]

DEFAULT_CHUNK_ROWS = 65_536

# the published batch_task.csv column order (headerless in the release)
CSV_COLUMNS = (
    "create_timestamp",
    "modify_timestamp",
    "job_id",
    "task_id",
    "instance_num",
    "status",
    "plan_cpu",
    "plan_mem",
)


@dataclasses.dataclass(frozen=True)
class TraceRow:
    """One validated ``batch_task.csv`` entry (= one task group)."""

    create_timestamp: int
    job_id: str
    task_id: str
    instance_num: int
    status: str


@dataclasses.dataclass(frozen=True)
class ClusterTraceConfig:
    path: str | None = None  # the CSV; None raises at generation
    n_jobs: int = 250  # cap, in arrival order (the paper's segment size)
    n_servers: int = 100
    seconds_per_slot: float = 10.0
    statuses: tuple[str, ...] = ("Terminated",)
    zipf_alpha: float = 1.0
    avail_lo: int = 8
    avail_hi: int = 12
    cap_lo: int = 3
    cap_hi: int = 5
    seed: int = 0
    chunk_rows: int = DEFAULT_CHUNK_ROWS  # streaming block size


def trace_available(path: str | None = None) -> bool:
    """True when ``path`` names a CSV that is present on disk."""
    return path is not None and os.path.isfile(path)


def _parse_int(value: str, column: str, line: int) -> int:
    try:
        return int(float(value))  # timestamps occasionally carry ".0"
    except ValueError:
        raise ValueError(
            f"batch_task.csv line {line}: column {column!r} must be "
            f"numeric, got {value!r}"
        ) from None


def iter_batch_task_csv(
    path: str,
    *,
    statuses: tuple[str, ...] = ("Terminated",),
    chunk_rows: int = DEFAULT_CHUNK_ROWS,
):
    """Stream a ``batch_task.csv``-shaped file as validated row blocks.

    Yields lists of :class:`TraceRow` of at most ``chunk_rows`` entries,
    so a multi-GB trace never materializes in memory.  Raises
    :class:`FileNotFoundError` when the file is absent (with a hint) and :class:`ValueError` on schema violations; rows whose
    status is not in ``statuses`` or whose ``instance_num`` is 0 are
    skipped (they carry no work).  Path and ``chunk_rows`` are validated
    eagerly at the call site, not at first iteration.
    """
    if chunk_rows <= 0:
        raise ValueError(f"chunk_rows must be positive, got {chunk_rows}")
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"cluster-trace-v2017 CSV not found at {path!r} — download "
            "batch_task.csv from the Alibaba clusterdata release and point "
            "ClusterTraceConfig.path at it"
        )
    return _iter_batch_task_rows(path, statuses, chunk_rows)


def _iter_batch_task_rows(
    path: str, statuses: tuple[str, ...], chunk_rows: int
):
    chunk: list[TraceRow] = []
    with open(path, newline="") as f:
        for line, record in enumerate(csv.reader(f), start=1):
            if not record or (len(record) == 1 and not record[0].strip()):
                continue  # blank line
            if line == 1 and record[0].strip() == CSV_COLUMNS[0]:
                continue  # optional header row
            if len(record) != len(CSV_COLUMNS):
                raise ValueError(
                    f"batch_task.csv line {line}: expected "
                    f"{len(CSV_COLUMNS)} columns {CSV_COLUMNS}, got "
                    f"{len(record)}"
                )
            create = _parse_int(record[0], "create_timestamp", line)
            instances = _parse_int(record[4], "instance_num", line)
            status = record[5].strip()
            if create < 0 or instances < 0:
                raise ValueError(
                    f"batch_task.csv line {line}: negative "
                    "create_timestamp/instance_num"
                )
            if not record[2].strip():
                raise ValueError(f"batch_task.csv line {line}: empty job_id")
            if status not in statuses or instances == 0:
                continue
            chunk.append(
                TraceRow(
                    create_timestamp=create,
                    job_id=record[2].strip(),
                    task_id=record[3].strip(),
                    instance_num=instances,
                    status=status,
                )
            )
            if len(chunk) >= chunk_rows:
                yield chunk
                chunk = []
    if chunk:
        yield chunk


def load_batch_task_csv(
    path: str, *, statuses: tuple[str, ...] = ("Terminated",)
) -> list[TraceRow]:
    """Whole-file convenience wrapper over :func:`iter_batch_task_csv`.

    Fine for fixtures and segments; full-length replays should stay on
    the chunked iterator (see :func:`generate_cluster_trace`).
    """
    rows: list[TraceRow] = []
    for chunk in iter_batch_task_csv(path, statuses=statuses):
        rows.extend(chunk)
    return rows


def generate_cluster_trace(cfg: ClusterTraceConfig, store=None) -> list[Job]:
    """Jobs from the CSV under the shared placement/capacity model.

    Each CSV row is one task group (``instance_num`` tasks); a job's
    arrival slot is its earliest ``create_timestamp`` quantised by
    ``seconds_per_slot``.  With ``store`` given the groups are
    registered as placement blocks (``PlacedJob``), exactly like the
    synthetic scenarios.

    The CSV is replayed in two streaming passes over
    :func:`iter_batch_task_csv` blocks: pass 1 records only each job's
    earliest timestamp to select the ``n_jobs`` arrival-order segment,
    pass 2 retains rows for the selected jobs — peak memory is the
    per-job timestamp map plus the selected segment, never the file.
    """
    path = cfg.path
    if path is None:
        raise FileNotFoundError(
            "no cluster-trace-v2017 CSV configured — set "
            "ClusterTraceConfig.path (generate('cluster_v2017', path=...))"
        )
    if cfg.seconds_per_slot <= 0:
        raise ValueError("seconds_per_slot must be positive")

    # pass 1: per-job earliest create_timestamp (O(#jobs) memory)
    earliest: dict[str, int] = {}
    for chunk in iter_batch_task_csv(
        path, statuses=cfg.statuses, chunk_rows=cfg.chunk_rows
    ):
        for row in chunk:
            prev = earliest.get(row.job_id)
            if prev is None or row.create_timestamp < prev:
                earliest[row.job_id] = row.create_timestamp
    if not earliest:
        raise ValueError(f"no usable rows in {path!r} (statuses={cfg.statuses})")
    # arrival order; ties broken by trace job id for determinism
    selected_ids = [
        job_id
        for job_id, _ in sorted(earliest.items(), key=lambda kv: (kv[1], kv[0]))
    ][: cfg.n_jobs]
    selected = set(selected_ids)

    # pass 2: retain rows for the selected segment only
    by_job: dict[str, list[TraceRow]] = {job_id: [] for job_id in selected_ids}
    for chunk in iter_batch_task_csv(
        path, statuses=cfg.statuses, chunk_rows=cfg.chunk_rows
    ):
        for row in chunk:
            if row.job_id in selected:
                by_job[row.job_id].append(row)
    ordered = [(job_id, by_job[job_id]) for job_id in selected_ids]

    t0 = min(earliest[job_id] for job_id in selected_ids)
    rng = np.random.default_rng(cfg.seed)
    jobs: list[Job] = []
    for j, (_, job_rows) in enumerate(ordered):
        arrival = int(
            (min(r.create_timestamp for r in job_rows) - t0) // cfg.seconds_per_slot
        )
        job_rows = sorted(job_rows, key=lambda r: (r.create_timestamp, r.task_id))
        sizes = [r.instance_num for r in job_rows]
        jobs.append(
            build_job(
                j,
                arrival,
                sum(sizes),
                n_servers=cfg.n_servers,
                zipf_alpha=cfg.zipf_alpha,
                avail_lo=cfg.avail_lo,
                avail_hi=cfg.avail_hi,
                cap_lo=cfg.cap_lo,
                cap_hi=cfg.cap_hi,
                rng=rng,
                store=store,
                group_sizes=sizes,
            )
        )
    return jobs
