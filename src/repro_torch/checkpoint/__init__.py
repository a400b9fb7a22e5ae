"""Fault-tolerant checkpointing: per-leaf .npy + manifest, the reference's
layout (each package reads the other's checkpoints)."""

from .store import (
    CheckpointManager,
    latest_step,
    read_manifest,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = [
    "CheckpointManager",
    "latest_step",
    "read_manifest",
    "restore_checkpoint",
    "save_checkpoint",
]
