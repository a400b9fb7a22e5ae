"""Back-compat façade over the scheduling engine.

The port's copy of ``repro/runtime/simulator.py``.  ``ClusterSimulator``
predates the pluggable-policy engine: it took a bare
assignment *function* plus ``reorder``/``accelerated`` flags.  It now
wraps :class:`repro_torch.runtime.engine.SchedulingEngine` with a policy built
from those arguments.  Semantics are unchanged for the historical usage
patterns (any ``assign`` under FIFO; WF under reordering); one deliberate
improvement: with ``reorder=True`` or under fault reassignment the given
``assign`` function is now used consistently, where the old simulator
hard-coded water-filling for those paths regardless of ``assign``.
New code should construct the engine directly:

    engine = SchedulingEngine(n_servers, make_policy("obta"))
    engine = SchedulingEngine(n_servers, make_policy("wf_torch", "ocwf-acc"))

Its default assignment is the host ``water_filling``, as in the
reference.
"""

from __future__ import annotations

from ..core import water_filling

from .engine import SchedulingEngine, SimResult
from .events import ServerEvent
from .policies import AssignFn, Policy

__all__ = ["ClusterSimulator", "ServerEvent", "SimResult"]


class ClusterSimulator(SchedulingEngine):
    """Drives a trace of :class:`repro_torch.core.Job` through the cluster."""

    def __init__(
        self,
        n_servers: int,
        assign: AssignFn = water_filling,
        *,
        reorder: bool = False,
        accelerated: bool = True,
        events: tuple[ServerEvent, ...] = (),
        max_slots: int = 10_000_000,
    ):
        ordering = ("ocwf-acc" if accelerated else "ocwf") if reorder else "fifo"
        policy = Policy(
            name=getattr(assign, "__name__", "custom"),
            assigner=assign,
            ordering=ordering,
        )
        super().__init__(
            n_servers, policy, events=events, max_slots=max_slots
        )
        self.assign = assign
        self.reorder = reorder
        self.accelerated = accelerated
