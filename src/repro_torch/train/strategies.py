"""DistributedStrategy: how one optimizer update is computed.

The Trainer treats every trainer in the paper as the same loop; the
strategy is the only part that differs, and it is a constructor argument
instead of a forked code path:

  Local          -- single-worker SGD/Adam (baseline CE, teacher, smoke)
  BMUFVmap       -- blockwise model-update filtering, the W worker lanes
                    W-stacked on one device (paper §3.5's 64-GPU
                    trainer); the lanes run as a loop
                    (``distributed/bmuf.py`` says why not vmap)
  GTC            -- Strom threshold-compressed SGD with error feedback
                    (paper §2/§3.4's 16-GPU trainer and the student
                    stage's default), single-process form
  GTCShardMap    -- GTC across W workers (the paper's sMBR trainer,
                    §3.4-3.5): W-stacked residuals, the W workers run as
                    a loop on one device, the int8 wire between them

``BMUFShardMap`` is not ported yet and raises.  A strategy exposes:

  microbatches          how many source batches one update consumes
                        (1 for Local/GTC; W for GTCShardMap; tau*W for
                        BMUF)
  n_workers             the worker membership W (1 for Local/GTC)
  stack(group)          fold that many batches into the update's input
  init_opt(params)      optimizer state (worker-stacked for BMUF)
  init_state(params)    strategy-private state carried in TrainState
  make_update(loss_fn)  update(state, batch, lr) -> (state, metrics)

``resize`` (elastic membership) comes with ROADMAP Queue 1, step 8.
PyTorch runs eagerly, so an update is a plain function: gradients come
from ``torch.autograd.grad`` and the update is functional on the
parameter tensors (new tensors, the old state untouched).
"""
from __future__ import annotations

import inspect
from typing import Any, Callable, List, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.distributed import bmuf as bmuf_lib
from repro_torch.distributed import gtc as gtc_lib
from repro_torch.optim import (adam_init, adam_update, clip_by_global_norm,
                               momentum_init, momentum_update)
from repro_torch.train.state import TrainState, fold_rng, fold_seed
from repro_torch.utils.trees import leaf_order


def loss_takes_rng(loss_fn: Callable) -> bool:
    """A loss opts into stochasticity by declaring an ``rng`` parameter:
    loss_fn(params, batch, rng=generator) -> (loss, metrics)."""
    try:
        return "rng" in inspect.signature(loss_fn).parameters
    except (TypeError, ValueError):
        return False


def call_loss(loss_fn: Callable, params, batch, rng=None):
    """Dispatch on the loss's arity; a stochastic loss with no generator
    gets a fixed one (the deterministic behavior of direct step calls
    outside the Trainer)."""
    if loss_takes_rng(loss_fn):
        return loss_fn(params, batch,
                       rng=fold_rng(0, 0) if rng is None else rng)
    return loss_fn(params, batch)


def loss_and_grads(loss_fn: Callable, params, batch, rng=None):
    """-> (loss, metrics, grads): the loss value detached, the loss's
    metrics (which it returns detached), and d loss / d params as a
    state dict in leaf order."""
    names = leaf_order(params)
    leaves = {n: params[n].detach().requires_grad_(True) for n in names}
    loss, metrics = call_loss(loss_fn, leaves, batch, rng)
    grads = torch.autograd.grad(loss, [leaves[n] for n in names])
    return loss.detach(), dict(metrics), dict(zip(names, grads))


def clipped_grads(loss_fn: Callable, params, batch, rng=None,
                  clip: float = 1.0):
    """-> (metrics, grads) with the grads clipped to global norm
    ``clip`` (0: unclipped) and the norm before clipping in
    ``metrics["grad_norm"]``."""
    _, metrics, grads = loss_and_grads(loss_fn, params, batch, rng)
    if clip:
        grads, metrics["grad_norm"] = clip_by_global_norm(grads, clip)
    return metrics, grads


_OPTIMIZERS = {"momentum": (momentum_init, momentum_update),
               "adam": (adam_init, adam_update)}


def _optimizer(name: str):
    """(init, update) of the named optimizer."""
    if name not in _OPTIMIZERS:
        raise ValueError(f"unknown optimizer {name!r}")
    return _OPTIMIZERS[name]


def make_sgd_step(loss_fn: Callable, *, optimizer: str = "momentum",
                  clip: float = 1.0):
    """The shared local step: grad -> clip -> optimizer.

    loss_fn(params, batch[, rng]) -> (loss, metrics).  Returns
    step(params, opt_state, batch, lr, rng=None) -> (params, opt_state,
    metrics).
    """
    _, upd = _optimizer(optimizer)

    def step(params, opt_state, batch, lr, rng=None):
        metrics, grads = clipped_grads(loss_fn, params, batch, rng, clip)
        params, opt_state = upd(params, grads, opt_state, lr=lr)
        return params, opt_state, metrics

    return step


def init_opt(params, optimizer: str = "momentum"):
    init, _ = _optimizer(optimizer)
    return init(params)


_ELASTIC = "ROADMAP Queue 1, step 8: multi-process and elastic runtime"


@runtime_checkable
class DistributedStrategy(Protocol):
    microbatches: int
    n_workers: int

    def init_opt(self, params) -> Any: ...
    def init_state(self, params) -> Any: ...
    def stack(self, group: List[dict]) -> Any: ...
    def make_update(self, loss_fn: Callable) -> Callable: ...


class _SingleWorker:
    """One source batch per update, no worker-stacked state."""

    microbatches = 1
    n_workers = 1

    def stack(self, group):
        return group[0]


class Local(_SingleWorker):
    """Plain single-worker training -- the degenerate strategy."""

    def __init__(self, *, optimizer: str = "momentum", clip: float = 1.0):
        self.optimizer = optimizer
        self.clip = clip

    def init_opt(self, params):
        return init_opt(params, self.optimizer)

    def init_state(self, params):
        return {}

    def make_update(self, loss_fn):
        step = make_sgd_step(loss_fn, optimizer=self.optimizer,
                             clip=self.clip)

        def update(state: TrainState, batch, lr):
            rng = fold_rng(state.rng, state.step)
            params, opt, metrics = step(state.params, state.opt_state,
                                        batch, lr, rng)
            return state.replace(params=params, opt_state=opt,
                                 step=state.step + 1), metrics

        return update


class GTC(_SingleWorker):
    """Threshold-compressed SGD with error feedback (Strom 2015).

    Single-process form, in the reference's order: grads -> clip ->
    ``gtc_lib.compress_tree`` against the carried residual (the
    ``gtc_compress`` kernel on the card) -> ``gtc_lib.wire_reduce``
    (at one worker a pack/unpack round-trip, bitwise identity on ternary
    sends) -> the optimizer -> ``gtc_density`` of the applied update.
    """

    def __init__(self, cfg: gtc_lib.GTCConfig = None, *,
                 optimizer: str = "momentum", clip: float = 1.0):
        self.cfg = cfg or gtc_lib.GTCConfig(n_workers=1)
        if self.cfg.n_workers != 1:
            raise ValueError(
                f"GTC is the single-process strategy; cfg.n_workers="
                f"{self.cfg.n_workers} needs GTCShardMap")
        _optimizer(optimizer)
        self.optimizer = optimizer
        self.clip = clip

    def init_opt(self, params):
        return init_opt(params, self.optimizer)

    def init_state(self, params):
        return gtc_lib.gtc_init(params)

    def make_update(self, loss_fn):
        _, upd = _optimizer(self.optimizer)
        cfg = self.cfg
        clip = self.clip

        def update(state: TrainState, batch, lr):
            metrics, grads = clipped_grads(
                loss_fn, state.params, batch,
                fold_rng(state.rng, state.step), clip)
            send, res = gtc_lib.compress_tree(
                grads, state.strategy_state["residual"], cfg.tau,
                use_kernel=cfg.use_kernel)
            applied = gtc_lib.wire_reduce(send, cfg)
            params, opt = upd(state.params, applied, state.opt_state, lr=lr)
            metrics["gtc_density"] = gtc_lib.density(applied, cfg.tau)
            return state.replace(params=params, opt_state=opt,
                                 strategy_state={"residual": res},
                                 step=state.step + 1), metrics

        return update


class BMUFVmap:
    """BMUF with the W lanes stacked on one device.  The name is the
    reference's; the lanes run as a loop (``distributed/bmuf.py``).  The
    sharded twin, one lane per process, comes with the elastic runtime
    (``BMUFShardMap``)."""

    def __init__(self, cfg: bmuf_lib.BMUFConfig, *,
                 optimizer: str = "momentum", clip: float = 1.0):
        _optimizer(optimizer)
        self.cfg = cfg
        self.optimizer = optimizer
        self.clip = clip

    @property
    def microbatches(self) -> int:
        return self.cfg.block_steps * self.cfg.n_workers

    @property
    def n_workers(self) -> int:
        return self.cfg.n_workers

    def resize(self, state: TrainState, w_new: int) -> TrainState:
        raise NotImplementedError(
            f"{type(self).__name__}.resize is not ported yet ({_ELASTIC})")

    def init_opt(self, params):
        one = init_opt(params, self.optimizer)
        return bmuf_lib.tmap(lambda x: x.expand(
            (self.cfg.n_workers,) + tuple(x.shape)).clone(), one)

    def init_state(self, params):
        st = bmuf_lib.bmuf_init(params, self.cfg)
        return {"delta": st["delta"], "workers": st["workers"]}

    def stack(self, group):
        """tau*W microbatches -> leaves of (tau, W, ...): microbatch i
        goes to local step i // W of lane i % W (the reference's
        ``reshape(tau, w, ...)``)."""
        tau, w = self.cfg.block_steps, self.cfg.n_workers
        return {k: torch.stack([torch.as_tensor(g[k]) for g in group])
                .reshape((tau, w) + tuple(np.shape(group[0][k])))
                for k in group[0]}

    def make_update(self, loss_fn):
        block = bmuf_lib.make_bmuf_block_step(
            make_sgd_step(loss_fn, optimizer=self.optimizer, clip=self.clip),
            self.cfg)

        def update(state: TrainState, batches, lr):
            bstate = {"theta_g": state.params, **state.strategy_state}
            bstate, opts, ms = block(bstate, state.opt_state, batches, lr,
                                     fold_seed(state.rng, state.step))
            # metrics arrive (W, tau)-shaped from the lanes' loop
            metrics = {k: v.float().mean() for k, v in ms.items()}
            return state.replace(
                params=bstate["theta_g"], opt_state=opts,
                strategy_state={"delta": bstate["delta"],
                                "workers": bstate["workers"]},
                step=state.step + 1), metrics

        return update


class GTCShardMap:
    """Multi-worker GTC: the paper's 16-GPU sequence trainer inside the
    Trainer.  Each update consumes ``n_workers`` microbatches (one per
    worker, stacked on a leading W dim); every worker compresses its
    grads (clipped to ``clip``, 0: unclipped) against its own carried
    residual (``TrainState.strategy_state``, W-stacked even at W = 1)
    and the wire is ``gtc_lib.make_sharded_gtc_train_step``'s: int8
    messages added at integer width, one unpack.  Params and optimizer
    state are shared: synchronous SGD.  The W workers run as a loop on
    the parameters' device (the reference's 1-device mesh); a ``mesh``
    other than None, and ``resize``, come with ROADMAP Queue 1, step 8.
    At W = 1 with a deterministic loss this is bitwise the single-process
    ``GTC``.  A loss that declares ``rng`` gets a generator per (update,
    worker), folded with the worker's global index, as BMUF's lanes do.
    """

    def __init__(self, cfg: gtc_lib.GTCConfig, mesh=None, *,
                 worker_axes=("data",), optimizer: str = "momentum",
                 clip: float = 1.0):
        if mesh is not None:
            raise NotImplementedError(
                f"GTCShardMap over a mesh is not ported yet ({_ELASTIC}); "
                "mesh=None runs the W workers on one device")
        _optimizer(optimizer)
        self.cfg = cfg
        self.worker_axes = worker_axes
        self.optimizer = optimizer
        self.clip = clip

    @property
    def microbatches(self) -> int:
        return self.cfg.n_workers

    @property
    def n_workers(self) -> int:
        return self.cfg.n_workers

    def init_opt(self, params):
        return init_opt(params, self.optimizer)

    def init_state(self, params):
        return gtc_lib.gtc_init(params, self.cfg)

    def resize(self, state: TrainState, w_new: int) -> TrainState:
        raise NotImplementedError(
            f"{type(self).__name__}.resize is not ported yet ({_ELASTIC})")

    def stack(self, group):
        """W microbatches -> leaves of (W, ...): worker i takes
        microbatch i."""
        return {k: torch.stack([torch.as_tensor(g[k]) for g in group])
                for k in group[0]}

    def _grad_transform(self):
        clip = self.clip
        if not clip:
            return None

        def transform(grads):
            grads, gn = clip_by_global_norm(grads, clip)
            return grads, {"grad_norm": gn}
        return transform

    def make_update(self, loss_fn):
        _, upd = _optimizer(self.optimizer)
        step = gtc_lib.make_sharded_gtc_train_step(
            loss_fn, upd, self.cfg, worker_axes=self.worker_axes,
            grad_transform=self._grad_transform())

        def update(state: TrainState, batches, lr):
            params, opt, gstate, ms = step(
                state.params, state.opt_state, state.strategy_state,
                batches, lr, fold_seed(state.rng, state.step))
            # metrics arrive (W,)-shaped from the workers' loop
            metrics = {k: v.float().mean() for k, v in ms.items()}
            return state.replace(params=params, opt_state=opt,
                                 strategy_state=gstate,
                                 step=state.step + 1), metrics

        return update


class _NotPorted:
    """A reference strategy this package does not have yet."""

    roadmap = ""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"{type(self).__name__} is not ported yet ({self.roadmap})")


class BMUFShardMap(_NotPorted):
    roadmap = _ELASTIC

