"""Job traces of the port: the ``alibaba`` and ``bursty`` scenarios.

``generate(scenario, **overrides)`` applies the overrides onto the
scenario's config dataclass, so a trace is pure configuration.  The
generators consume the RNG exactly as the reference's do, so the same
config gives the reference's jobs.
"""

from __future__ import annotations

from typing import Callable

from .. import registry
from ..core import Job
from .alibaba_like import TraceConfig, generate_trace
from .bursty import BurstyTraceConfig, generate_bursty_trace

__all__ = [
    "BurstyTraceConfig",
    "TRACES",
    "TraceConfig",
    "generate",
    "generate_bursty_trace",
    "generate_trace",
    "list_scenarios",
]

# scenario -> (config dataclass, generator); the live "scenario" kind view
TRACES: dict[str, tuple[type, Callable]] = registry.kind_dict("scenario")

registry.register("scenario", "alibaba", (TraceConfig, generate_trace), overwrite=True)
registry.register(
    "scenario", "bursty", (BurstyTraceConfig, generate_bursty_trace), overwrite=True
)


def generate(scenario: str, **overrides) -> list[Job]:
    """Generate a trace by scenario name with config-field overrides."""
    try:
        cfg_cls, gen = TRACES[scenario]
    except KeyError:
        raise KeyError(
            f"unknown trace scenario {scenario!r}; registered: {sorted(TRACES)}"
        ) from None
    return gen(cfg_cls(**overrides))


def list_scenarios() -> list[str]:
    return sorted(TRACES)
