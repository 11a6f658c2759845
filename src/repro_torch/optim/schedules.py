"""LR schedules. The paper uses exponential decay over (sub-)epochs.

A ``Schedule`` is a per-*update* learning-rate policy: callable
``step -> lr`` plus a marker type the data plane recognizes.  Sources
(``repro_torch.train.data``) pass Schedule objects through
``TrainBatch.lr`` untouched, and ``Trainer.fit`` evaluates them at the
update counter on the host.

The arithmetic is the reference's float32 arithmetic (numpy float32
here, jnp there), so a schedule gives the reference's learning rates.
Plain callables keep their meaning in ``epoch_source`` (a function of
the *epoch*); only Schedule instances get per-step treatment.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

F32 = np.float32


class Schedule:
    """A per-update LR policy: ``schedule(step) -> float``; ``fn`` maps
    the 0-based optimizer-update counter to a learning rate."""

    def __init__(self, fn: Callable[[int], float], desc: str = ""):
        self._fn = fn
        self.desc = desc

    def __call__(self, step: int) -> float:
        return float(self._fn(step))

    def __repr__(self) -> str:
        return f"Schedule({self.desc or self._fn!r})"


def exponential_decay(lr0: float, decay: float,
                      steps_per_epoch: int) -> Schedule:
    def fn(step):
        return lr0 * decay ** (step // steps_per_epoch)
    return Schedule(fn, f"exp(lr0={lr0}, decay={decay}, "
                        f"spe={steps_per_epoch})")


def warmup_exponential(lr0: float, warmup_steps: int, decay: float,
                       steps_per_epoch: int) -> Schedule:
    def fn(step):
        s = F32(step)
        warm = np.minimum(F32(1.0), (s + F32(1)) / F32(max(warmup_steps, 1)))
        epoch = np.floor(s / F32(steps_per_epoch))
        return F32(lr0) * warm * (F32(decay) ** epoch)
    return Schedule(fn, f"warmup_exp(lr0={lr0}, warmup={warmup_steps}, "
                        f"decay={decay}, spe={steps_per_epoch})")


def warmup_hold_decay(lr0: float, warmup_steps: int, hold_steps: int,
                      decay: float, steps_per_epoch: int, *,
                      floor: float = 0.0) -> Schedule:
    """Linear warmup -> flat hold at lr0 -> per-epoch exponential decay,
    clamped at ``floor``."""
    def fn(step):
        s = F32(step)
        warm = np.minimum(F32(1.0), (s + F32(1)) / F32(max(warmup_steps, 1)))
        past_hold = np.maximum(F32(0.0),
                               s - F32(warmup_steps) - F32(hold_steps))
        epoch = np.floor(past_hold / F32(steps_per_epoch))
        return np.maximum(F32(floor), F32(lr0) * warm * (F32(decay) ** epoch))
    return Schedule(fn, f"warmup_hold_decay(lr0={lr0}, "
                        f"warmup={warmup_steps}, hold={hold_steps}, "
                        f"decay={decay}, spe={steps_per_epoch})")
