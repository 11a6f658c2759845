"""DistributedStrategy: how one optimizer update is computed.

The Trainer treats every trainer in the paper as the same loop; the
strategy is the only part that differs, and it is a constructor argument
instead of a forked code path:

  Local          -- single-worker SGD/Adam (baseline CE, teacher, smoke)
  GTC            -- Strom threshold-compressed SGD with error feedback
                    (paper §2/§3.4's 16-GPU trainer and the student
                    stage's default), single-process form

``BMUFVmap``, ``BMUFShardMap`` and ``GTCShardMap`` are not ported yet and
raise.  A strategy exposes ``init_opt(params)``, ``init_state(params)``
and ``make_update(loss_fn) -> update(state, batch, lr) -> (state,
metrics)``; both ported strategies take one source batch per update
(the reference's ``microbatches`` / ``stack`` come with BMUF).
PyTorch runs eagerly, so an update is a plain function: gradients come
from ``torch.autograd.grad`` and the update is functional on the
parameter tensors (new tensors, the old state untouched).
"""
from __future__ import annotations

import inspect
from typing import Any, Callable, Protocol, runtime_checkable

import torch

from repro_torch.distributed import gtc as gtc_lib
from repro_torch.optim import (adam_init, adam_update, clip_by_global_norm,
                               momentum_init, momentum_update)
from repro_torch.train.state import TrainState, fold_rng
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


@runtime_checkable
class DistributedStrategy(Protocol):
    def init_opt(self, params) -> Any: ...
    def init_state(self, params) -> Any: ...
    def make_update(self, loss_fn: Callable) -> Callable: ...


class Local:
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


class GTC:
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
                f"{self.cfg.n_workers} needs GTCShardMap, which is not "
                "ported yet")
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


class _NotPorted:
    """A reference strategy this package does not have yet."""

    roadmap = ""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"{type(self).__name__} is not ported yet ({self.roadmap})")


class BMUFVmap(_NotPorted):
    roadmap = "ROADMAP Queue 1: labeled stages and BMUF"


class BMUFShardMap(_NotPorted):
    roadmap = "ROADMAP Queue 1: multi-process and elastic runtime"


class GTCShardMap(_NotPorted):
    roadmap = "ROADMAP Queue 1: sMBR and multi-worker GTC"

