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
continues instead of restarting.  Under a fleet of ranks rank 0 writes
and clears the checkpoints while the others wait (``runtime.cluster
.on_leader``), and ``fit`` waits for every rank after reading the resume
state.  ``prefetch=N`` (constructor or fit
kwarg) wraps the source in ``pipeline.PrefetchingSource``, staging
batches on the parameters' device ahead of the update.

Elasticity: ``fit(..., membership=...)`` polls a live-worker count
(anything with ``live_count()``) at update (== BMUF block) boundaries;
when it changes, ``Trainer.resize`` re-partitions the TrainState through
the strategy's ``resize`` and rebuilds the updates for the new W
(``resize_stats`` counts resizes and their seconds).  Checkpoints record
the membership they were saved at (``meta["n_workers"]``), and resume at
a *different* W re-partitions the loaded state: a W = 4 save restarts on
a W = 2 fleet.  Under a fleet of ranks only rank 0 holds and polls the
membership (the other ranks pass None): it broadcasts each live count,
so every rank resizes its mesh to the same W at the same block; the
lanes' collectives pair up only if they do.  ``polls`` records each
poll's update, W and this rank's lanes.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointStore
from repro_torch.runtime.cluster import (barrier, broadcast_object,
                                         is_leader, on_leader, world_size)
from repro_torch.train.data import DataSource
from repro_torch.train.metrics import MetricsSink
from repro_torch.train.state import TrainState
from repro_torch.train.strategies import DistributedStrategy
from repro_torch.utils.trees import leaf_order, tree_paths


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
        self._loss_fns = loss_fns
        self._build_updates()
        # membership-change accounting, read by the elastic runs
        self.resize_stats = {"count": 0, "seconds": 0.0}
        # every membership poll of the last fit: the update it followed,
        # the W adopted and, on a mesh, this rank's lanes
        self.polls = []
        self.checkpoint = checkpoint
        self.ckpt_every = ckpt_every
        self.metrics = metrics
        # prefetch > 0: fit() wraps its source in a PrefetchingSource of
        # that depth (pipeline/prefetch.py)
        self.prefetch = prefetch

    def _build_updates(self):
        self.updates = {tag: self.strategy.make_update(fn)
                        for tag, fn in self._loss_fns.items()}

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
        """Adopt a new worker membership mid-run: re-partition the
        TrainState through the strategy and rebuild the updates for the
        new W-shaped inputs.  Called from fit() at update boundaries when
        a membership poll reports a change, and from resume when the
        checkpoint was saved at another W."""
        if w_new == getattr(self.strategy, "n_workers", w_new):
            return state
        t0 = time.perf_counter()
        state = self.strategy.resize(state, w_new)
        self._build_updates()
        self.resize_stats["count"] += 1
        self.resize_stats["seconds"] += time.perf_counter() - t0
        return state

    def _gather(self, state: TrainState) -> TrainState:
        """The single-process (W-stacked) form of ``state``."""
        gather = getattr(self.strategy, "gather_state", None)
        return state if gather is None else gather(state)

    def _save(self, state: TrainState, consumed: int):
        meta = {"consumed": consumed}
        w = getattr(self.strategy, "n_workers", None)
        if w is not None:
            meta["n_workers"] = int(w)
        tree = self._gather(state).to_dict()
        on_leader(lambda: self.checkpoint.save(
            int(state.step), tree, meta=meta))

    def _load(self, template: TrainState, step: int) -> TrainState:
        """The checkpoint at ``step`` into ``template``'s shapes (its
        W-stacked form), then this rank's rows of it."""
        tree, _ = self.checkpoint.load(self._gather(template).to_dict(),
                                       step)
        state = TrainState.from_dict(tree)
        cut = getattr(self.strategy, "cut_state", None)
        return state if cut is None else cut(state)

    def _try_resume(self, state: TrainState):
        """-> (state, consumed) from the latest checkpoint, or None.

        Cross-W resume: when the checkpoint's saved membership differs
        from the strategy's current W, the load template is first
        resized to the *saved* W (``load_tree`` is strict about shapes),
        then the loaded state is resized back to the current W -- a W = 4
        save resumes on a W = 2 fleet with residuals folded
        sum-preservingly and BMUF replicas re-stacked."""
        if self.checkpoint is None:
            return None
        step = self.checkpoint.latest()
        if step is None:
            return None
        meta = self.checkpoint.load_meta(step) or {}
        cur_w = getattr(self.strategy, "n_workers", None)
        saved_w = meta.get("n_workers")
        consumed = int(meta.get("consumed", 0))
        if cur_w is not None and saved_w is not None \
                and int(saved_w) != int(cur_w):
            template = self.strategy.resize(state, int(saved_w))
            return self.resize(self._load(template, step), cur_w), consumed
        return self._load(state, step), consumed

    # --------------------------------------------------------------- fit

    def fit(self, state: TrainState, source: DataSource, *,
            resume: bool = True,
            max_updates: Optional[int] = None,
            prefetch: Optional[int] = None,
            membership=None) -> TrainState:
        """Run the source through the strategy's updates,
        ``strategy.microbatches`` source batches per update, resuming
        from the latest checkpoint when ``resume``.  Stops after
        ``max_updates`` when given.  ``membership`` (anything with
        ``live_count()``) is polled before the first update and after
        each one; a changed count resizes the run (floor 1).  Under a
        fleet only rank 0's ``membership`` is polled, every rank
        following its count; the other ranks pass None."""
        consumed = 0
        if resume:
            loaded = self._try_resume(state)
            if loaded is not None:
                state, consumed = loaded
        # under a fleet every rank has read the resume state before any
        # rank writes the next checkpoint (a no-op alone)
        barrier()
        poll = self._poller(membership)
        self.polls = []
        if poll is not None:
            state = self._poll_membership(state, poll)
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
            return self._fit_loop(state, source, consumed, max_updates,
                                  poll)
        finally:
            if wrapped is not None:         # early exit must not leak the
                wrapped.close()             # producer thread across stages

    @staticmethod
    def _poller(membership):
        """``membership`` as a function returning the live count, or None
        (not elastic).  Under a fleet only rank 0 reads its membership
        and broadcasts whether there is one and, at each poll, the
        count: a rank polling a roster of its own could see a kill one
        poll earlier or later than rank 0 and resize to another W."""
        if world_size() == 1:
            return (None if membership is None
                    else lambda: membership.live_count())
        if not broadcast_object(membership is not None):
            return None
        return lambda: broadcast_object(
            int(membership.live_count()) if is_leader() else None)

    def _poll_membership(self, state: TrainState, poll) -> TrainState:
        """One membership check (``poll()``: the live count); a changed
        count resizes state, strategy and updates.  The floor is 1: an
        all-dead fleet freezes rather than divides by zero."""
        live = max(1, int(poll()))
        if live != getattr(self.strategy, "n_workers", live):
            state = self.resize(state, live)
        mesh = getattr(self.strategy, "mesh", None)
        self.polls.append({"step": int(state.step), "n_workers": live,
                           "lanes": None if mesh is None
                           else list(mesh.lanes)})
        return state

    def _fit_loop(self, state: TrainState, source, consumed: int,
                  max_updates: Optional[int], poll=None) -> TrainState:
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
            if poll is not None:
                # update == block boundary: the only membership-safe
                # point (BMUF lanes were just re-broadcast, GTC residuals
                # are between compressions)
                new = self._poll_membership(state, poll)
                if new is not state:
                    state = new
                    need = self.strategy.microbatches
        return state

    # ------------------------------------------------------------ finish

    def finalize(self, state: TrainState):
        """Mark the run complete: drop the resume checkpoints so a fresh
        invocation of the same stage trains anew (a *killed* run, by
        contrast, still has them and resumes)."""
        if self.checkpoint is not None:
            on_leader(self.checkpoint.clear)
        return state
