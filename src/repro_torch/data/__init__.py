"""Locality-aware input pipeline (the paper's scheduler in the data plane).

The port's counterpart of ``repro/data``."""

from .pipeline import LocalityAwareLoader, ShardStore

__all__ = ["LocalityAwareLoader", "ShardStore"]
