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
store's reads as CPU tensors); the loss function moves them to the
parameters' device.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

from repro_torch.core import scheduled
from repro_torch.optim.schedules import Schedule

# shards copied out of a v2 store's memory maps by distill_shard_source
SHARD_COPIES = 0


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
                         loss: str = "distill_topk", *,
                         verify: bool = False,
                         pin_wave: bool = False) -> Iterator[TrainBatch]:
    """Unlabeled batches [lo, hi) joined with their LogitStore shards
    (shard i holds batch i's teacher top-k — the trainer-aligned layout
    target generation writes).  Works against v1 (``core.logit_store``)
    and v2 (``store``) stores alike; with a v2 store, ``verify=True``
    checksums each shard before it is fed.

    ``pin_wave=True`` (v2 stores) snapshots the live manifest entries
    when iteration starts and reads through *those* for the whole
    sub-epoch: a teacher regeneration superseding shards mid-epoch
    cannot silently switch this pass onto new-wave targets half way
    through — retired files stay on disk until the store's next
    ``gc()``, so the pinned reads keep resolving.

    A v2 read is a read-only memory map, which a tensor cannot wrap
    (``torch.as_tensor`` warns that it is not writable): each such
    shard is copied into host tensors here, once, and counted in
    ``SHARD_COPIES``.
    """
    global SHARD_COPIES
    entries = None
    if pin_wave and hasattr(store, "manifest"):
        # taken lazily, at first next(): scheduled_source builds each
        # sub-epoch's source up front, but the pin belongs to the
        # moment the sub-epoch starts consuming
        entries = {bi: store.manifest.entry(bi)
                   for bi in range(lo, min(hi, len(batches)))}
    for bi in range(lo, min(hi, len(batches))):
        b = batches[bi]
        if entries is not None:
            vals, idx = store.read_entry(entries[bi], verify=verify)
        elif verify:
            vals, idx = store.read_shard(bi, verify=True)
        else:
            vals, idx = store.read_shard(bi)
        if isinstance(vals, np.ndarray):
            vals, idx = torch.tensor(vals), torch.tensor(idx)
            SHARD_COPIES += 1
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
