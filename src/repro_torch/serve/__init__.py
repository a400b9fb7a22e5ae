"""Serving: prefill/decode steps, continuous batching, replica routing,
WF-balanced MoE expert replicas."""

from .engine import (
    ReplicaRouter,
    Request,
    RoutedServePool,
    ServeEngine,
    make_decode_step,
    make_prefill_step,
)
from .moe_balance import balance_expert_replicas, replica_placement

__all__ = [
    "ReplicaRouter",
    "Request",
    "RoutedServePool",
    "ServeEngine",
    "balance_expert_replicas",
    "make_decode_step",
    "make_prefill_step",
    "replica_placement",
]
