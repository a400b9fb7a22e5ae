"""Job traces of the port: the ``alibaba``, ``bursty`` and
``pareto_diurnal`` scenarios, the ``cluster_v2017`` CSV replay, open-loop
clients and resilience drills.

``generate(scenario, **overrides)`` applies the overrides onto the
scenario's config dataclass, so a trace is pure configuration.  The
generators consume the RNG exactly as the reference's do, so the same
config gives the reference's jobs.  Pass ``store=`` (a
:class:`repro_torch.placement.PlacementStore`) to get placement-backed
jobs whose eligible sets resolve from the store at arrival time —
bit-identical to the frozen trace when the store is static.

``cluster_v2017`` replays a ``batch_task.csv``-shaped file whose path
is given as ``generate("cluster_v2017", path=...)`` (the port reads no
environment variable); without a path it raises
:class:`FileNotFoundError`, :func:`scenario_available` says whether
a scenario can generate, and :func:`available_scenarios` lists those
that can without a path.
"""

from __future__ import annotations

from typing import Callable

from .. import registry
from ..core import Job
from .alibaba_like import TraceConfig, generate_trace
from .bursty import BurstyTraceConfig, generate_bursty_trace
from .clients import poisson_client, replay_client
from .cluster_v2017 import (
    ClusterTraceConfig,
    generate_cluster_trace,
    iter_batch_task_csv,
    load_batch_task_csv,
    trace_available,
)
from .pareto import ParetoTraceConfig, generate_pareto_trace
from .resilience import overload_client, rack_failure_timeline, saturation_qps

__all__ = [
    "BurstyTraceConfig",
    "ClusterTraceConfig",
    "ParetoTraceConfig",
    "TRACES",
    "TraceConfig",
    "available_scenarios",
    "generate",
    "generate_bursty_trace",
    "generate_cluster_trace",
    "generate_pareto_trace",
    "generate_trace",
    "iter_batch_task_csv",
    "list_scenarios",
    "load_batch_task_csv",
    "overload_client",
    "poisson_client",
    "rack_failure_timeline",
    "replay_client",
    "saturation_qps",
    "scenario_available",
]

# scenario -> (config dataclass, generator); the live "scenario" kind view
TRACES: dict[str, tuple[type, Callable]] = registry.kind_dict("scenario")

for _name, _entry in {
    "alibaba": (TraceConfig, generate_trace),
    "bursty": (BurstyTraceConfig, generate_bursty_trace),
    "pareto_diurnal": (ParetoTraceConfig, generate_pareto_trace),
    "cluster_v2017": (ClusterTraceConfig, generate_cluster_trace),
}.items():
    registry.register("scenario", _name, _entry, overwrite=True)
del _name, _entry


def generate(scenario: str, *, store=None, **overrides) -> list[Job]:
    """Generate a trace by scenario name with config-field overrides;
    ``store`` switches the scenario to placement-backed jobs."""
    try:
        cfg_cls, gen = TRACES[scenario]
    except KeyError:
        raise KeyError(
            f"unknown trace scenario {scenario!r}; registered: {sorted(TRACES)}"
        ) from None
    return gen(cfg_cls(**overrides), store=store)


def list_scenarios() -> list[str]:
    return sorted(TRACES)


def scenario_available(scenario: str, path: str | None = None) -> bool:
    """True when the scenario can generate right now — synthetic ones
    always can; ``cluster_v2017`` needs ``path`` to name its CSV on disk."""
    if scenario not in TRACES:
        return False
    if scenario == "cluster_v2017":
        return trace_available(path)
    return True


def available_scenarios() -> list[str]:
    """Registered scenarios that can generate without a path (what
    benchmark sweeps should default to): the synthetic ones."""
    return [s for s in list_scenarios() if scenario_available(s)]
