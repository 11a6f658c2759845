"""DataSource: anything that yields (batch, lr, loss-kind) work items.

A data source is an iterable of ``TrainBatch`` -- the Trainer consumes
them in order.  The source functions of the paper's stages:

  epoch_source          labeled CE epochs
  distill_shard_source  unlabeled batches joined with LogitStore shards
  scheduled_source      the §3.3 scheduled-learning phase stream:
                        unlabeled distill sub-epochs interleaved with
                        labeled CE passes, per-phase LR from the
                        exponential schedule in core/scheduled.py

Sources must be *deterministic* (same items in the same order each time
they are built).  Batch data stay on the host (numpy arrays, or the
store's CPU tensors); the loss function moves them to the parameters'
device.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Iterator

from repro_torch.core import scheduled
from repro_torch.optim.schedules import Schedule


@dataclass
class TrainBatch:
    """One microbatch of work: data dict + the LR and loss to use.

    ``lr`` is a float or an ``optim.schedules.Schedule`` -- schedules
    ride through the source untouched and are evaluated by Trainer.fit
    at the update counter.
    """
    data: Any
    lr: Any
    loss: str = "default"


DataSource = Iterable[TrainBatch]


def epoch_source(batches_fn: Callable[[int], Iterable[dict]],
                 n_epochs: int, lr, loss: str = "default"
                 ) -> Iterator[TrainBatch]:
    """n_epochs passes over batches_fn(epoch); lr a float, a Schedule
    (passed through for per-update evaluation), or fn(epoch)."""
    for ep in range(n_epochs):
        lr_ep = lr if isinstance(lr, Schedule) else (
            lr(ep) if callable(lr) else lr)
        for b in batches_fn(ep):
            yield TrainBatch(b, lr_ep, loss)


def distill_shard_source(batches, store, lo: int, hi: int, lr,
                         loss: str = "distill_topk") -> Iterator[TrainBatch]:
    """Unlabeled batches [lo, hi) joined with their LogitStore shards
    (shard i holds batch i's teacher top-k: the trainer-aligned layout
    target generation writes), from the v1 store
    (``core.logit_store.LogitStore``).  The v2 store's ``verify`` and
    ``pin_wave`` come with that store."""
    for bi in range(lo, min(hi, len(batches))):
        b = batches[bi]
        vals, idx = store.read_shard(bi)
        yield TrainBatch({"feats": b["feats"], "mask": b["mask"],
                          "topk_vals": vals, "topk_idx": idx}, lr, loss)


def scheduled_source(cfg: scheduled.ScheduleConfig, *,
                     unlabeled: Callable[[scheduled.Phase],
                                         Iterable[TrainBatch]],
                     labeled: Callable[[scheduled.Phase],
                                       Iterable[TrainBatch]]
                     ) -> Iterator[TrainBatch]:
    """Walk the paper's phase schedule, delegating batch production to
    per-phase callbacks (which see the phase's lr / chunking / offset)."""
    for phase in scheduled.schedule(cfg):
        fn = unlabeled if phase.kind == "unlabeled" else labeled
        yield from fn(phase)


def chain(*sources: DataSource) -> Iterator[TrainBatch]:
    """Concatenate sources into one stream."""
    return itertools.chain(*sources)
