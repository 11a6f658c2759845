"""Trainer.fit(): the one loop every training stage of the recipe runs.

    trainer = Trainer(strategy, {"ce": loss_fn}, metrics=sink)
    state = trainer.init_state(params)
    state = trainer.fit(state, source)

One update function per loss kind, with the learning rate a runtime
argument.  The strategy decides what an update does; the source decides
what data arrives with which lr/loss; the Trainer only counts and emits
metrics.  Every ported strategy takes one source batch per update; the
grouping of BMUF's tau*W microbatches comes with BMUF.
``TrainBatch.lr`` may be a float or an ``optim.schedules.Schedule``;
schedules are evaluated at the update counter on the host.

Not ported yet: periodic checkpoints and mid-stage resume (they come
with the ``checkpoint/store.py`` twin), the prefetching feed and elastic
membership.  ``checkpoint``, ``ckpt_every``, ``prefetch`` and
``membership`` are accepted only as ``None`` / ``0``; anything else
raises.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import torch

from repro_torch.train.data import DataSource
from repro_torch.train.metrics import MetricsSink
from repro_torch.train.state import TrainState
from repro_torch.train.strategies import DistributedStrategy
from repro_torch.utils.trees import leaf_order

_RESUME = "ROADMAP Queue 1: checkpoint, resume and prefetch"


def _not_ported(what: str, where: str):
    raise NotImplementedError(f"{what} is not ported yet ({where})")


class Trainer:
    def __init__(self, strategy: DistributedStrategy,
                 loss_fns: Union[Callable, Dict[str, Callable]], *,
                 checkpoint=None, ckpt_every: int = 0,
                 metrics: Optional[MetricsSink] = None,
                 prefetch: int = 0):
        if checkpoint is not None or ckpt_every:
            _not_ported("checkpoint/resume", _RESUME)
        if prefetch:
            _not_ported("the prefetching feed", _RESUME)
        self.strategy = strategy
        if callable(loss_fns):
            loss_fns = {"default": loss_fns}
        self.updates = {tag: strategy.make_update(fn)
                        for tag, fn in loss_fns.items()}
        self.metrics = metrics

    def init_state(self, params, *, seed: int = 0) -> TrainState:
        """A fresh TrainState over ``params`` (a state dict, put in the
        reference's leaf order)."""
        params = {n: params[n] for n in leaf_order(params)}
        return TrainState(params=params,
                          opt_state=self.strategy.init_opt(params),
                          strategy_state=self.strategy.init_state(params),
                          step=0, rng=seed)

    def fit(self, state: TrainState, source: DataSource, *,
            max_updates: Optional[int] = None,
            prefetch: Optional[int] = None,
            membership=None) -> TrainState:
        """Run the source through the strategy's updates, one source
        batch per update (every ported strategy is single-worker), with
        ``TrainBatch.lr`` evaluated at the update counter when it is a
        Schedule.  Stops after ``max_updates`` when given."""
        if prefetch:
            _not_ported("the prefetching feed", _RESUME)
        if membership is not None:
            _not_ported("elastic membership",
                        "ROADMAP Queue 1: multi-process and elastic runtime")
        return self._fit_loop(state, source, max_updates)

    def _fit_loop(self, state: TrainState, source,
                  max_updates: Optional[int]) -> TrainState:
        start_step = state.step
        for tb in source:
            if tb.loss not in self.updates:
                raise KeyError(
                    f"source yielded loss kind {tb.loss!r} but the Trainer "
                    f"only has {sorted(self.updates)}")
            lr = tb.lr(state.step) if callable(tb.lr) else tb.lr
            state, metrics = self.updates[tb.loss](state, tb.data, float(lr))
            if self.metrics is not None:
                self.metrics.emit(state.step, tb.loss, {
                    k: float(v) for k, v in metrics.items()
                    if not torch.is_tensor(v) or v.numel() == 1})
            if max_updates is not None and \
                    state.step - start_step >= max_updates:
                break
        return state
