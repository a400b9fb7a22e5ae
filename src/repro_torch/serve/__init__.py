"""Serving: prefill/decode steps, continuous batching, replica routing."""

from .engine import (
    ReplicaRouter,
    Request,
    RoutedServePool,
    ServeEngine,
    make_decode_step,
    make_prefill_step,
)

__all__ = [
    "ReplicaRouter",
    "Request",
    "RoutedServePool",
    "ServeEngine",
    "make_decode_step",
    "make_prefill_step",
]
