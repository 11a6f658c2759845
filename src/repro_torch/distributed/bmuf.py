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
row w of the new stacked state.  The sharded path
(``make_sharded_bmuf_block_step``, one lane per process) comes with
ROADMAP Queue 1, step 8.
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
    from repro_torch.train.state import fold_rng
    from repro_torch.train.strategies import loss_takes_rng
    takes_rng = loss_takes_rng(train_step)

    def block(state, opt_states, batches, lr, rng=None, active=None):
        workers = state["workers"]
        n_lanes = next(iter(workers.values())).shape[0]
        tau = next(iter(batches.values())).shape[0]
        new_workers = {n: torch.empty_like(w) for n, w in workers.items()}
        new_opt = tmap(torch.empty_like, opt_states)
        lanes = []
        for w in range(n_lanes):
            p = {n: x[w] for n, x in workers.items()}
            o = tmap(lambda x: x[w], opt_states)
            ms = []
            for i in range(tau):
                b = tmap(lambda x: x[i, w], batches)
                if takes_rng and rng is not None:
                    p, o, m = train_step(p, o, b, lr,
                                         rng=fold_rng(rng, w, i))
                else:
                    p, o, m = train_step(p, o, b, lr)
                ms.append(m)
            for n, x in p.items():
                new_workers[n][w].copy_(x)
            tmap(lambda dst, src: dst[w].copy_(src), new_opt, o)
            lanes.append(ms)
        metrics = {k: torch.stack([torch.stack([torch.as_tensor(m[k])
                                                for m in ms])
                                   for ms in lanes])
                   for k in lanes[0][0]}
        state = block_sync(dict(state, workers=new_workers), cfg,
                           active=active)
        return state, new_opt, metrics

    return block
