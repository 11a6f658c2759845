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
                    §3.4-3.5): W-stacked residuals, the W workers a loop
                    on one device (``mesh=None``) or this rank's lanes
                    on a ``runtime.cluster.WorkerMesh``, the int8 wire
                    between them
  BMUFShardMap   -- BMUF on a ``WorkerMesh``: this rank's lanes, one
                    ``all_reduce`` a leaf at the block sync

On a mesh of ranks a strategy holds this rank's rows only: ``stack``
keeps its lanes' microbatches, ``init_state`` / ``init_opt`` its lanes'
rows (one replica a rank at one lane a rank, not W), metrics come back
gathered to the full W in lane order, and ``gather_state`` /
``cut_state`` turn a TrainState into the single-process W-stacked one
and back (the Trainer's checkpoints are the single-process files).
A strategy exposes:

  microbatches          how many source batches one update consumes
                        (1 for Local/GTC; W for GTCShardMap; tau*W for
                        BMUF)
  n_workers             the *current* worker membership W (1 for
                        Local/GTC) -- a runtime value
  stack(group)          fold that many batches into the update's input
  init_opt(params)      optimizer state (worker-stacked for BMUF)
  init_state(params)    strategy-private state carried in TrainState
  make_update(loss_fn)  update(state, batch, lr) -> (state, metrics)
  resize(state, W_new)  re-partition W-stacked state onto a new
                        membership (elastic join/leave, cross-W resume)
                        and retune the strategy, so later make_update
                        calls build W_new-shaped updates

PyTorch runs eagerly, so an update is a plain function: gradients come
from ``torch.autograd.grad`` and the update is functional on the
parameter tensors (new tensors, the old state untouched).
"""
from __future__ import annotations

import dataclasses
import inspect
import math
from typing import Any, Callable, List, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.distributed import bmuf as bmuf_lib
from repro_torch.distributed import gtc as gtc_lib
from repro_torch.optim import (adam_init, adam_update, clip_by_global_norm,
                               momentum_init, momentum_update)
from repro_torch.runtime.cluster import check_mesh, worker_mesh
from repro_torch.train.state import (TrainState, cut_lanes, fold_rng,
                                     fold_seed, gather_lanes,
                                     restack_workers)
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
    state dict in leaf order.  Every parameter must reach the loss
    (autograd raises otherwise) but those under a prefix the loss names
    in its ``unreached`` attribute (deepseek-v3's MTP block under the
    distill loss): they get a zero gradient, as under JAX's ``grad``."""
    names = leaf_order(params)
    leaves = {n: params[n].detach().requires_grad_(True) for n in names}
    loss, metrics = call_loss(loss_fn, leaves, batch, rng)
    skip = tuple(getattr(loss_fn, "unreached", ()))
    reached = [n for n in names if not n.startswith(skip)] if skip else names
    grads = dict(zip(reached, torch.autograd.grad(
        loss, [leaves[n] for n in reached])))
    return loss.detach(), dict(metrics), {
        n: grads[n] if n in grads else torch.zeros_like(params[n])
        for n in names}


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


def _stack_rows(group, rows, lead=()):
    """Leaves of ``group``'s microbatches at indices ``rows`` stacked on
    a new leading dim, reshaped to ``lead + (len(rows),)``; zero rows
    give empty leaves of that shape."""
    out = {}
    for k in group[0]:
        x0 = torch.as_tensor(group[0][k])
        if rows:
            x = torch.stack([torch.as_tensor(group[i][k]) for i in rows])
        else:
            x = torch.empty((0,) + tuple(x0.shape), dtype=x0.dtype)
        out[k] = x.reshape(tuple(lead) + (len(rows) // math.prod(lead),)
                           + tuple(x0.shape))
    return out


@runtime_checkable
class DistributedStrategy(Protocol):
    microbatches: int
    n_workers: int

    def init_opt(self, params) -> Any: ...
    def init_state(self, params) -> Any: ...
    def stack(self, group: List[dict]) -> Any: ...
    def make_update(self, loss_fn: Callable) -> Callable: ...
    def resize(self, state: "TrainState", w_new: int) -> "TrainState": ...


class _SingleWorker:
    """One source batch per update, no worker-stacked state: the only
    membership it can express is W = 1, so any other target is a caller
    error, not something to absorb silently."""

    microbatches = 1
    n_workers = 1

    def stack(self, group):
        return group[0]

    def resize(self, state: TrainState, w_new: int) -> TrainState:
        if w_new != 1:
            raise ValueError(
                f"{type(self).__name__} is single-worker; cannot resize "
                f"to W={w_new}")
        return state


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
    reference's; the lanes run as a loop (``distributed/bmuf.py`` says
    why not vmap).  The sharded twin, this rank's lanes on a mesh of
    ranks, is ``BMUFShardMap``."""

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
        """Re-stack the lanes' replicas and per-lane optimizer state onto
        a new membership.  Safe at block boundaries (the only place the
        Trainer calls it): the Nesterov restart has just broadcast the
        same params to every lane, so shrink keeps the first W_new lanes
        and grow warm-starts joiners from lane 0.  The block momentum
        ``delta`` is global and carries unchanged."""
        if w_new == self.cfg.n_workers:
            return state
        self.cfg = dataclasses.replace(self.cfg, n_workers=w_new)
        ss = dict(state.strategy_state)
        ss["workers"] = restack_workers(ss["workers"], w_new)
        return state.replace(
            opt_state=restack_workers(state.opt_state, w_new),
            strategy_state=ss)

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

    def _block(self, loss_fn):
        return bmuf_lib.make_bmuf_block_step(
            make_sgd_step(loss_fn, optimizer=self.optimizer, clip=self.clip),
            self.cfg)

    def make_update(self, loss_fn):
        block = self._block(loss_fn)

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


class BMUFShardMap(BMUFVmap):
    """BMUF with the lanes on a ``runtime.cluster.WorkerMesh`` of ranks
    (production): this rank's ``mesh.lanes`` run their tau local steps
    with no collective, and the block sync's mean is one ``all_reduce``
    a leaf (``distributed/bmuf.py:make_sharded_bmuf_block_step``).  The
    lanes' replicas and optimizer state hold this rank's rows; theta_g
    and the block momentum are shared.  On the one-rank mesh of a single
    process this is ``BMUFVmap`` bitwise.  ``resize`` gathers the rows,
    re-stacks them as ``BMUFVmap`` does, rebuilds ``worker_mesh(W_new)``
    and cuts again; the world size does not change."""

    def __init__(self, cfg: bmuf_lib.BMUFConfig, mesh, *,
                 worker_axes=("data",), optimizer: str = "momentum",
                 clip: float = 1.0):
        super().__init__(cfg, optimizer=optimizer, clip=clip)
        check_mesh("BMUFShardMap", mesh, cfg.n_workers)
        self.mesh = mesh
        self.worker_axes = worker_axes

    def init_opt(self, params):
        one = init_opt(params, self.optimizer)
        return bmuf_lib.tmap(lambda x: x.expand(
            (len(self.mesh.lanes),) + tuple(x.shape)).clone(), one)

    def init_state(self, params):
        st = bmuf_lib.bmuf_init(params, dataclasses.replace(
            self.cfg, n_workers=len(self.mesh.lanes)))
        return {"delta": st["delta"], "workers": st["workers"]}

    def stack(self, group):
        """tau*W microbatches -> leaves of (tau, L, ...) for this rank's
        L lanes: lane l's local step i takes microbatch i * W + l."""
        tau, w = self.cfg.block_steps, self.cfg.n_workers
        return _stack_rows(group, [i * w + lane for i in range(tau)
                                   for lane in self.mesh.lanes], (tau,))

    def gather_state(self, state: TrainState) -> TrainState:
        """The single-process TrainState: every rank's lanes' replicas
        and optimizer state, W-stacked in lane order."""
        ss = dict(state.strategy_state)
        ss["workers"] = gather_lanes(ss["workers"], self.mesh)
        return state.replace(opt_state=gather_lanes(state.opt_state,
                                                    self.mesh),
                             strategy_state=ss)

    def cut_state(self, state: TrainState) -> TrainState:
        """This rank's rows of a W-stacked TrainState."""
        ss = dict(state.strategy_state)
        ss["workers"] = cut_lanes(ss["workers"], self.mesh)
        return state.replace(opt_state=cut_lanes(state.opt_state,
                                                 self.mesh),
                             strategy_state=ss)

    def resize(self, state: TrainState, w_new: int) -> TrainState:
        if w_new == self.cfg.n_workers:
            return state
        full = super().resize(self.gather_state(state), w_new)
        self.mesh = worker_mesh(w_new, axis=self.mesh.axis)
        return self.cut_state(full)

    def _block(self, loss_fn):
        return bmuf_lib.make_sharded_bmuf_block_step(
            make_sgd_step(loss_fn, optimizer=self.optimizer, clip=self.clip),
            self.cfg, self.mesh, worker_axes=self.worker_axes)


class GTCShardMap:
    """Multi-worker GTC: the paper's 16-GPU sequence trainer inside the
    Trainer.  Each update consumes ``n_workers`` microbatches (one per
    worker, stacked on a leading dim); every worker compresses its grads
    (clipped to ``clip``, 0: unclipped) against its own carried residual
    (``TrainState.strategy_state``) and the wire is
    ``gtc_lib.make_sharded_gtc_train_step``'s: int8 messages added at
    integer width, one unpack.  Params and optimizer state are shared:
    synchronous SGD.  ``mesh=None`` runs the W workers as a loop on the
    parameters' device (the reference's 1-device mesh), residuals
    W-stacked even at W = 1; a ``runtime.cluster.WorkerMesh`` runs this
    rank's lanes, holds their residual rows only, and sums the ranks'
    messages with one ``all_reduce`` a leaf -- bitwise the loop on the
    integer wires.  ``resize`` folds the residuals onto the new W,
    keeping their sum (on a mesh: gathered, folded, cut for
    ``worker_mesh(W_new)``).  At W = 1 with a deterministic loss this is
    bitwise the single-process ``GTC``.  A loss that declares ``rng``
    gets a generator per (update, worker), folded with the worker's
    global index, as BMUF's lanes do.
    """

    def __init__(self, cfg: gtc_lib.GTCConfig, mesh=None, *,
                 worker_axes=("data",), optimizer: str = "momentum",
                 clip: float = 1.0):
        if mesh is not None:
            check_mesh("GTCShardMap", mesh, cfg.n_workers)
        _optimizer(optimizer)
        self.cfg = cfg
        self.mesh = mesh
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
        if self.mesh is None:
            return gtc_lib.gtc_init(params, self.cfg)
        return gtc_lib.gtc_init(params, dataclasses.replace(
            self.cfg, n_workers=len(self.mesh.lanes)))

    def gather_state(self, state: TrainState) -> TrainState:
        """The single-process TrainState: every worker's residual,
        W-stacked in lane order."""
        if self.mesh is None:
            return state
        return state.replace(strategy_state=gather_lanes(
            state.strategy_state, self.mesh))

    def cut_state(self, state: TrainState) -> TrainState:
        """This rank's residual rows of a W-stacked TrainState."""
        if self.mesh is None:
            return state
        return state.replace(strategy_state=cut_lanes(
            state.strategy_state, self.mesh))

    def resize(self, state: TrainState, w_new: int) -> TrainState:
        """Re-partition the per-worker error-feedback residuals onto a
        new membership with ``fold=True``: a dropped worker's unshipped
        error mass is added onto a survivor, a joiner starts with zero
        residual -- both keep the sum, so sends + final residuals ==
        grads holds across the resize."""
        if w_new == self.cfg.n_workers:
            return state
        full = self.gather_state(state)
        self.cfg = dataclasses.replace(self.cfg, n_workers=w_new)
        full = full.replace(strategy_state=restack_workers(
            full.strategy_state, w_new, fold=True))
        if self.mesh is not None:
            self.mesh = worker_mesh(w_new, axis=self.mesh.axis)
        return self.cut_state(full)

    def stack(self, group):
        """W microbatches -> leaves of (W, ...): worker i takes
        microbatch i; on a mesh, this rank's lanes' rows only."""
        return _stack_rows(group, list(range(len(group)))
                           if self.mesh is None else list(self.mesh.lanes))

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
            loss_fn, upd, self.cfg, self.mesh, worker_axes=self.worker_axes,
            grad_transform=self._grad_transform())

        def update(state: TrainState, batches, lr):
            params, opt, gstate, ms = step(
                state.params, state.opt_state, state.strategy_state,
                batches, lr, fold_seed(state.rng, state.step))
            # metrics arrive (W,)-shaped: the workers' loop, or the
            # ranks' lanes gathered in lane order
            metrics = {k: v.float().mean() for k, v in ms.items()}
            return state.replace(params=params, opt_state=opt,
                                 strategy_state=gstate,
                                 step=state.step + 1), metrics

        return update
