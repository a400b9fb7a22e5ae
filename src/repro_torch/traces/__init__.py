"""Job traces of the port: the ``alibaba``, ``bursty`` and
``pareto_diurnal`` scenarios, open-loop clients and resilience drills.

``generate(scenario, **overrides)`` applies the overrides onto the
scenario's config dataclass, so a trace is pure configuration.  The
generators consume the RNG exactly as the reference's do, so the same
config gives the reference's jobs.  Pass ``store=`` (a
:class:`repro_torch.placement.PlacementStore`) to get placement-backed
jobs whose eligible sets resolve from the store at arrival time —
bit-identical to the frozen trace when the store is static.

The reference's fourth scenario, ``cluster_v2017`` (a CSV replay), waits
for a later slice: the port's copy will take the CSV's path as an
argument instead of reading it from the environment.
"""

from __future__ import annotations

from typing import Callable

from .. import registry
from ..core import Job
from .alibaba_like import TraceConfig, generate_trace
from .bursty import BurstyTraceConfig, generate_bursty_trace
from .clients import poisson_client, replay_client
from .pareto import ParetoTraceConfig, generate_pareto_trace
from .resilience import overload_client, rack_failure_timeline, saturation_qps

__all__ = [
    "BurstyTraceConfig",
    "ParetoTraceConfig",
    "TRACES",
    "TraceConfig",
    "generate",
    "generate_bursty_trace",
    "generate_pareto_trace",
    "generate_trace",
    "list_scenarios",
    "overload_client",
    "poisson_client",
    "rack_failure_timeline",
    "replay_client",
    "saturation_qps",
]

# scenario -> (config dataclass, generator); the live "scenario" kind view
TRACES: dict[str, tuple[type, Callable]] = registry.kind_dict("scenario")

for _name, _entry in {
    "alibaba": (TraceConfig, generate_trace),
    "bursty": (BurstyTraceConfig, generate_bursty_trace),
    "pareto_diurnal": (ParetoTraceConfig, generate_pareto_trace),
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
