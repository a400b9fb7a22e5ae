"""Cluster runtime of the port: slot-stepped engine, cluster state, policies.

Layered as engine (slot-exact drive + admission) → policies (assignment
× ordering) → cluster (queues + eq. 2 busy state).
"""

from .cluster import ClusterState, QueueSegment
from .engine import SchedulingEngine, SimResult
from .policies import (
    ORDERINGS,
    Policy,
    SchedulingPolicy,
    get_assigner,
    list_policies,
    make_policy,
)

__all__ = [
    "ClusterState",
    "ORDERINGS",
    "Policy",
    "QueueSegment",
    "SchedulingEngine",
    "SchedulingPolicy",
    "SimResult",
    "get_assigner",
    "list_policies",
    "make_policy",
]
