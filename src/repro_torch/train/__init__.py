"""Training: optimizer, loss, train step (on one device, or sharded on a
mesh), int8 gradient compression.

The port's counterpart of ``repro/train``.  ``compress.py`` (int8 with
error feedback over an axis collective) is the optional data-parallel
reduction, as the reference's.
"""

from .optim import AdamWConfig, adamw_init, adamw_update
from .step import TrainState, make_train_step, shard_train_state, train_state_init

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "TrainState",
    "make_train_step",
    "shard_train_state",
    "train_state_init",
]
