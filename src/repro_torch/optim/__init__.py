"""Functional optimizers and LR schedules (the reference's ``optim``)."""
from repro_torch.optim.schedules import (Schedule, exponential_decay,
                                         warmup_exponential,
                                         warmup_hold_decay)
from repro_torch.optim.sgd import (adam_init, adam_update,
                                   clip_by_global_norm, momentum_init,
                                   momentum_update)

__all__ = ["Schedule", "exponential_decay", "warmup_exponential",
           "warmup_hold_decay", "adam_init", "adam_update",
           "clip_by_global_norm", "momentum_init", "momentum_update"]
