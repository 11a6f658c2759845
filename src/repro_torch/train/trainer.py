"""Trainer.fit(): the one loop every training stage of the recipe runs.

    trainer = Trainer(strategy, {"ce": loss_fn}, checkpoint=store,
                      ckpt_every=25, metrics=sink)
    state = trainer.init_state(params)
    state = trainer.fit(state, source)

One update function per loss kind, with the learning rate a runtime
argument.  The strategy decides how many source microbatches one update
consumes (W for GTCShardMap, tau*W for BMUF; a group of them must share
one batch shape, so full-sequence batches come padded to one length)
and what the update does; the source decides
what data arrives with which lr/loss; the Trainer only grooms batches
into blocks, counts, checkpoints and emits metrics.
``TrainBatch.lr`` may be a float or an ``optim.schedules.Schedule``;
schedules are evaluated at the update counter on the host.

Resume: every ``ckpt_every`` updates the full TrainState plus the
consumed-microbatch count goes to the CheckpointStore (the reference's
file and meta, ``{"consumed", "n_workers"}``); ``fit`` with
``resume=True`` (default) reloads the latest state and fast-forwards
the (deterministic) source past the consumed prefix, so a killed stage
continues instead of restarting.  ``prefetch=N`` (constructor or fit
kwarg) wraps the source in ``pipeline.PrefetchingSource``, staging
batches on the parameters' device ahead of the update.

Not ported yet: elastic membership (``fit(membership=)``), and with it
resuming a checkpoint saved at another worker count; both raise, naming
ROADMAP Queue 1, step 8.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointStore
from repro_torch.train.data import DataSource
from repro_torch.train.metrics import MetricsSink
from repro_torch.train.state import TrainState
from repro_torch.train.strategies import DistributedStrategy
from repro_torch.utils.trees import leaf_order, tree_paths

_ELASTIC = "ROADMAP Queue 1, step 8: multi-process and elastic runtime"


def _shape_sig(data):
    """Hashable signature of a batch's leaf shapes."""
    return tuple(tuple(np.shape(x)) for _, x in tree_paths(data))


def _device_of(params) -> torch.device:
    return next(iter(params.values())).device


class Trainer:
    def __init__(self, strategy: DistributedStrategy,
                 loss_fns: Union[Callable, Dict[str, Callable]], *,
                 checkpoint: Optional[CheckpointStore] = None,
                 ckpt_every: int = 0,
                 metrics: Optional[MetricsSink] = None,
                 prefetch: int = 0):
        self.strategy = strategy
        if callable(loss_fns):
            loss_fns = {"default": loss_fns}
        self.updates = {tag: strategy.make_update(fn)
                        for tag, fn in loss_fns.items()}
        self.checkpoint = checkpoint
        self.ckpt_every = ckpt_every
        self.metrics = metrics
        # prefetch > 0: fit() wraps its source in a PrefetchingSource of
        # that depth (pipeline/prefetch.py)
        self.prefetch = prefetch

    # ------------------------------------------------------------- state

    def init_state(self, params, *, seed: int = 0) -> TrainState:
        """A fresh TrainState over ``params`` (a state dict, put in the
        reference's leaf order)."""
        params = {n: params[n] for n in leaf_order(params)}
        return TrainState(params=params,
                          opt_state=self.strategy.init_opt(params),
                          strategy_state=self.strategy.init_state(params),
                          step=0, rng=seed)

    def resize(self, state: TrainState, w_new: int) -> TrainState:
        """Adopting a new worker membership mid-run is the elastic
        runtime's; it raises until then."""
        raise NotImplementedError(
            f"Trainer.resize is not ported yet ({_ELASTIC})")

    def _save(self, state: TrainState, consumed: int):
        meta = {"consumed": consumed}
        w = getattr(self.strategy, "n_workers", None)
        if w is not None:
            meta["n_workers"] = int(w)
        self.checkpoint.save(int(state.step), state.to_dict(), meta=meta)

    def _try_resume(self, state: TrainState):
        """-> (state, consumed) from the latest checkpoint, or None.  A
        checkpoint saved at another worker count raises: re-partitioning
        it is the elastic runtime's ``resize``."""
        if self.checkpoint is None:
            return None
        step = self.checkpoint.latest()
        if step is None:
            return None
        meta = self.checkpoint.load_meta(step) or {}
        cur_w = getattr(self.strategy, "n_workers", None)
        saved_w = meta.get("n_workers")
        if cur_w is not None and saved_w is not None \
                and int(saved_w) != int(cur_w):
            raise NotImplementedError(
                f"the checkpoint at step {step} was saved at "
                f"n_workers={saved_w}, the strategy has {cur_w}: "
                f"cross-W resume is not ported yet ({_ELASTIC})")
        tree, step = self.checkpoint.load(state.to_dict(), step)
        return TrainState.from_dict(tree), int(meta.get("consumed", 0))

    # --------------------------------------------------------------- fit

    def fit(self, state: TrainState, source: DataSource, *,
            resume: bool = True,
            max_updates: Optional[int] = None,
            prefetch: Optional[int] = None,
            membership=None) -> TrainState:
        """Run the source through the strategy's updates,
        ``strategy.microbatches`` source batches per update, resuming
        from the latest checkpoint when ``resume``.  Stops after
        ``max_updates`` when given."""
        if membership is not None:
            raise NotImplementedError(
                f"elastic membership is not ported yet ({_ELASTIC})")
        consumed = 0
        if resume:
            loaded = self._try_resume(state)
            if loaded is not None:
                state, consumed = loaded
        depth = self.prefetch if prefetch is None else prefetch
        wrapped = None
        if depth:
            from repro_torch.pipeline.prefetch import PrefetchingSource
            if not isinstance(source, PrefetchingSource):
                # skip_put: the resume replay drops the consumed prefix,
                # so the producer must not pay its device transfers
                source = PrefetchingSource(
                    source, depth=depth, skip_put=consumed,
                    device=_device_of(state.params))
            wrapped = source
        try:
            return self._fit_loop(state, source, consumed, max_updates)
        finally:
            if wrapped is not None:         # early exit must not leak the
                wrapped.close()             # producer thread across stages

    def _fit_loop(self, state: TrainState, source, consumed: int,
                  max_updates: Optional[int]) -> TrainState:
        start_step = state.step
        need = self.strategy.microbatches
        n_seen = 0
        group, gtag, gsig, glr = [], None, None, None
        for tb in source:
            n_seen += 1
            if n_seen <= consumed:          # resume: replay + skip
                continue
            # a partial block cannot straddle a loss-kind, batch-shape or
            # lr boundary: drop it (BMUF block semantics).  Local/GTC
            # never hit this (need == 1).  Schedule objects compare by
            # identity, so one schedule spanning many updates never
            # splits a block.
            sig = _shape_sig(tb.data) if need > 1 else None
            if group and (tb.loss != gtag or sig != gsig
                          or tb.lr != glr):
                group = []
            if not group:
                gtag, gsig, glr = tb.loss, sig, tb.lr
            group.append(tb.data)
            if len(group) < need:
                continue
            if gtag not in self.updates:
                raise KeyError(
                    f"source yielded loss kind {gtag!r} but the Trainer "
                    f"only has {sorted(self.updates)}")
            batch = self.strategy.stack(group)
            lr = glr(state.step) if callable(glr) else glr
            state, metrics = self.updates[gtag](state, batch, float(lr))
            group = []
            consumed = n_seen
            if self.metrics is not None:
                self.metrics.emit(state.step, gtag, {
                    k: float(v) for k, v in metrics.items()
                    if not torch.is_tensor(v) or v.numel() == 1})
            if (self.checkpoint is not None and self.ckpt_every
                    and state.step % self.ckpt_every == 0):
                self._save(state, consumed)
            if max_updates is not None and \
                    state.step - start_step >= max_updates:
                break
        return state

    # ------------------------------------------------------------ finish

    def finalize(self, state: TrainState):
        """Mark the run complete: drop the resume checkpoints so a fresh
        invocation of the same stage trains anew (a *killed* run, by
        contrast, still has them and resumes)."""
        if self.checkpoint is not None:
            self.checkpoint.clear()
        return state
