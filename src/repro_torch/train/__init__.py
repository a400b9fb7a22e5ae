"""Training on one device: optimizer, loss, train step.

The port's counterpart of ``repro/train``.  Gradient compression
(``compress.py``: int8 with error feedback over an axis collective) waits
for the port's ``parallel/``.
"""

from .optim import AdamWConfig, adamw_init, adamw_update
from .step import TrainState, make_train_step, train_state_init

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "TrainState",
    "make_train_step",
    "train_state_init",
]
