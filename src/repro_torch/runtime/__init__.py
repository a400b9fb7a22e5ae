"""Cluster runtime of the port: scheduling engine, cluster state, events,
policies, and the event-stepped control plane.

Layered as loop (event-stepped control plane) → engine (slot-exact
drive + admission/fault/placement machinery) → policies (assignment ×
ordering) → cluster (queues + eq. 2 busy state) → events (fault
timeline).  ``ClusterSimulator`` remains as the legacy façade.  Copies
of the reference's ``repro/runtime`` modules of the same names.
"""

from .cluster import ClusterState, QueueSegment
from .engine import SchedulingEngine, SimResult
from .events import EventTimeline, RackEvent, ServerEvent
from .loop import ControlPlane
from .policies import (
    ORDERINGS,
    Policy,
    SchedulingPolicy,
    get_assigner,
    list_policies,
    make_policy,
)
from .resilience import ResilienceConfig, ResilienceState
from .simulator import ClusterSimulator

__all__ = [
    "ClusterSimulator",
    "ClusterState",
    "ControlPlane",
    "EventTimeline",
    "ORDERINGS",
    "Policy",
    "QueueSegment",
    "RackEvent",
    "ResilienceConfig",
    "ResilienceState",
    "SchedulingEngine",
    "SchedulingPolicy",
    "ServerEvent",
    "SimResult",
    "get_assigner",
    "list_policies",
    "make_policy",
]
