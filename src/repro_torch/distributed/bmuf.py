"""Blockwise Model-Update Filtering (paper §3.5; Chen & Huo, ICASSP 2016).

The paper's 64-GPU trainer for the SSL CE stage: each worker runs local
SGD for a *block* of steps on its own data shard, then the workers sync:

    G_t      = mean_w(theta_w) - theta_g            (block "gradient")
    Delta_t  = eta * Delta_{t-1} + zeta * G_t        (block momentum eta,
                                                      block LR zeta)
    theta_g <- theta_g + Delta_t
    restart  = theta_g + eta * Delta_t               (Nesterov, NBM)

The twin of the reference's ``distributed/bmuf.py`` (``BMUFConfig``,
``bmuf_init``, ``active_mean_fn``, ``block_sync``,
``make_bmuf_block_step``).  The state is W-stacked as in the reference:
``workers`` and each lane's optimizer state carry a leading W dim.

The lanes run as a loop on one device, not under ``torch.func.vmap``:
the distill loss reaches the ``sparse_ce`` kernel through a ctypes
launch inside a ``torch.autograd.Function``, neither of which vmap can
batch, and a vmapped path that took the plain version instead would be
a fallback.  Lane w's tau local steps read views of row w and write
row w of the new stacked state.

``make_sharded_bmuf_block_step`` runs the same block on a
``runtime.cluster.WorkerMesh``: the state, optimizer state and batches
hold this rank's lanes' rows, the lanes' local steps run with no
collective (each folds its generator with its global lane index), and
the block sync's mean is one ``all_reduce(SUM)`` a leaf of the local
lanes' sums, divided by W -- with an ``active`` mask, the masked sums
and the live count, the divisor floored at 1, as the reference's
psum of masked local sums over a psum'd count.  The sum is regrouped
across ranks, so a mesh of ranks agrees with the one-device loop to
float32 rounding, not bitwise; the one-rank mesh of a single process is
the one-device loop itself.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch


@dataclass(frozen=True)
class BMUFConfig:
    n_workers: int = 64
    block_steps: int = 8             # tau: local steps per block
    block_momentum: float = 0.875    # eta; Chen&Huo suggest 1 - 1/W-ish
    block_lr: float = 1.0            # zeta
    nesterov: bool = True            # NBM variant


def tmap(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(tree, dict):
        return {k: tmap(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def bmuf_init(global_params, cfg: BMUFConfig):
    """-> {theta_g, delta, workers}: workers stacked on a leading W dim."""
    workers = {n: p.expand((cfg.n_workers,) + tuple(p.shape)).clone()
               for n, p in global_params.items()}
    delta = {n: torch.zeros_like(p, dtype=torch.float32)
             for n, p in global_params.items()}
    return {"theta_g": global_params, "delta": delta, "workers": workers}


def active_mean_fn(active):
    """Worker-mean over live lanes only: ``active`` is a (W,) 0/1 mask.

    Dead lanes contribute nothing to the block average; the divisor is
    the live count (floored at 1 so an all-dead mask freezes the model
    instead of dividing by zero).  ``delta`` is global and needs no
    masking.
    """
    a = torch.as_tensor(active, dtype=torch.float32)
    denom = torch.clamp(a.sum(), min=1.0)

    def mean_fn(w):
        aw = a.to(w.device).reshape((-1,) + (1,) * (w.dim() - 1))
        return torch.sum(w.float() * aw, dim=0) / denom.to(w.device)

    return mean_fn


def block_sync(state, cfg: BMUFConfig, *, mean_fn=None, active=None):
    """One BMUF sync. ``mean_fn`` overrides the worker-mean; default =
    mean over the leading W dim.  ``active`` (a (W,) 0/1 mask, ignored
    when ``mean_fn`` is given) restricts the average to live workers.
    The Nesterov restart still broadcasts to *all* lanes."""
    if mean_fn is None:
        if active is not None:
            mean_fn = active_mean_fn(active)
        else:
            mean_fn = lambda w: torch.mean(w.float(), dim=0)  # noqa: E731
    eta, zeta = cfg.block_momentum, cfg.block_lr
    theta_g, delta, workers = state["theta_g"], state["delta"], \
        state["workers"]
    new_theta, new_delta, new_workers = {}, {}, {}
    for n, tg in theta_g.items():
        g = mean_fn(workers[n]) - tg.float()
        d = eta * delta[n] + zeta * g
        t = (tg.float() + d).to(tg.dtype)
        restart = (t.float() + eta * d).to(tg.dtype) if cfg.nesterov else t
        new_theta[n], new_delta[n] = t, d
        new_workers[n] = restart.to(workers[n].dtype).expand_as(
            workers[n]).contiguous()
    return {"theta_g": new_theta, "delta": new_delta,
            "workers": new_workers}


def _local_steps(train_step: Callable, takes_rng: bool, workers,
                 opt_states, batches, lr, rng, lanes):
    """tau local steps on each row of ``workers``; row j is global lane
    ``lanes[j]`` (its generator ``fold_rng(rng, lanes[j], i)``).  ->
    (new workers, new optimizer states, metrics (rows, tau))."""
    from repro_torch.train.state import fold_rng
    tau = next(iter(batches.values())).shape[0]
    new_workers = {n: torch.empty_like(w) for n, w in workers.items()}
    new_opt = tmap(torch.empty_like, opt_states)
    rows = []
    for j, lane in enumerate(lanes):
        p = {n: x[j] for n, x in workers.items()}
        o = tmap(lambda x: x[j], opt_states)
        ms = []
        for i in range(tau):
            b = tmap(lambda x: x[i, j], batches)
            if takes_rng and rng is not None:
                p, o, m = train_step(p, o, b, lr, rng=fold_rng(rng, lane, i))
            else:
                p, o, m = train_step(p, o, b, lr)
            ms.append(m)
        for n, x in p.items():
            new_workers[n][j].copy_(x)
        tmap(lambda dst, src: dst[j].copy_(src), new_opt, o)
        rows.append(ms)
    metrics = {k: torch.stack([torch.stack([torch.as_tensor(m[k])
                                            for m in ms])
                               for ms in rows])
               for k in rows[0][0]} if rows else {}
    return new_workers, new_opt, metrics


def make_bmuf_block_step(train_step: Callable, cfg: BMUFConfig):
    """One *block*: tau local steps on each of the W lanes, then the sync.

    train_step(params, opt_state, batch, lr[, rng]) -> (params,
    opt_state, metrics).  ``batches``: a dict of leaves with leading
    dims (tau, W, ...); lane w's local step i takes ``[i, w]``.
    ``rng`` (an int from ``train.state.fold_seed``, optional) gives each
    (lane, local step) its own generator, ``fold_rng(rng, w, i)``, for
    steps that declare one.  ``active`` (optional (W,) 0/1 mask) drops
    dead lanes from the block average; their local steps still run.
    Returns (state, opt_states, metrics), each metric (W, tau)-shaped.
    """
    from repro_torch.train.strategies import loss_takes_rng
    takes_rng = loss_takes_rng(train_step)

    def block(state, opt_states, batches, lr, rng=None, active=None):
        workers = state["workers"]
        n_lanes = next(iter(workers.values())).shape[0]
        new_workers, new_opt, metrics = _local_steps(
            train_step, takes_rng, workers, opt_states, batches, lr, rng,
            range(n_lanes))
        state = block_sync(dict(state, workers=new_workers), cfg,
                           active=active)
        return state, new_opt, metrics

    return block


def mesh_mean_fn(mesh, n_workers: int, active=None):
    """The block sync's worker-mean on a mesh of ranks: this rank's rows
    summed (zeros on a rank without lanes), one ``all_reduce`` over the
    ranks, divided by W -- or, with a (W,) 0/1 ``active`` mask, the
    masked sums over the all-reduced live count, floored at 1."""
    dev = torch.device(mesh.device) if mesh.device else None
    if active is None:
        denom = torch.tensor(float(n_workers), device=dev)
        a_local = None
    else:
        a = torch.as_tensor(active, dtype=torch.float32)
        a_local = a[list(mesh.lanes)].to(dev)
        live = mesh.all_reduce(a_local.sum().reshape(1))
        denom = torch.clamp(live[0], min=1.0)

    def mean_fn(w):
        x = w.float()
        if a_local is not None:
            x = x * a_local.to(w.device).reshape((-1,) + (1,) * (w.dim() - 1))
        s = mesh.all_reduce(torch.sum(x, dim=0))
        return s / denom.to(s.device)

    return mean_fn


def make_sharded_bmuf_block_step(train_step: Callable, cfg: BMUFConfig,
                                 mesh, worker_axes=("data",)):
    """BMUF on a ``runtime.cluster.WorkerMesh``: the block of
    ``make_bmuf_block_step`` over this rank's lanes.

    ``state["workers"]``, ``opt_states`` and ``batches`` ((tau, L, ...))
    hold the rows of ``mesh.lanes``; ``theta_g`` and ``delta`` are
    shared.  Local steps are collective-free; the sync is one
    ``all_reduce`` a leaf (``mesh_mean_fn``), then the reference's
    momentum, global update and Nesterov restart, written into this
    rank's rows.  ``active`` is the global (W,) mask.  Metrics come back
    (W, tau)-shaped, gathered in lane order.  The one-rank mesh of a
    single process runs ``make_bmuf_block_step`` itself.
    ``worker_axes`` is the reference's; the mesh has one axis.
    """
    from repro_torch.runtime.cluster import check_mesh
    from repro_torch.train.state import gather_lanes
    from repro_torch.train.strategies import loss_takes_rng
    del worker_axes
    check_mesh("make_sharded_bmuf_block_step", mesh, cfg.n_workers)
    if not mesh.distributed:
        return make_bmuf_block_step(train_step, cfg)
    takes_rng = loss_takes_rng(train_step)

    def block(state, opt_states, batches, lr, rng=None, active=None):
        new_workers, new_opt, metrics = _local_steps(
            train_step, takes_rng, state["workers"], opt_states, batches,
            lr, rng, mesh.lanes)
        state = block_sync(dict(state, workers=new_workers), cfg,
                           mean_fn=mesh_mean_fn(mesh, cfg.n_workers, active))
        return state, new_opt, gather_lanes(metrics, mesh)

    return block
