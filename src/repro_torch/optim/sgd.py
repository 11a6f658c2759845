"""Optimizers, hand-rolled and functional (no ``torch.optim``): Nesterov
SGD-momentum (the paper's trainer) and Adam.  Params, grads and states
are dicts of tensors walked in the reference's leaf order, and each
formula is the reference's term for term, so updates agree with it to
float32 rounding."""
from __future__ import annotations

import torch

from repro_torch.utils.trees import leaf_order


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled so their global L2 norm is at most ``max_norm``,
    the norm before scaling).  The norm sums the leaves in the
    reference's order."""
    names = leaf_order(grads)
    gn = torch.sqrt(sum(torch.sum(torch.square(grads[n].float()))
                        for n in names))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return {n: (grads[n].float() * scale).to(grads[n].dtype)
            for n in names}, gn


# ----------------------------------------------------------- SGD momentum

def momentum_init(params):
    return {"mu": {n: torch.zeros(params[n].shape, dtype=torch.float32,
                                  device=params[n].device)
                   for n in leaf_order(params)}}


def momentum_update(params, grads, state, *, lr, beta: float = 0.9,
                    nesterov: bool = True):
    names = leaf_order(params)
    mu = {n: beta * state["mu"][n] + grads[n].float() for n in names}
    step = ({n: beta * mu[n] + grads[n].float() for n in names}
            if nesterov else mu)
    new_params = {n: (params[n].float() - lr * step[n]).to(params[n].dtype)
                  for n in names}
    return new_params, {"mu": mu}


# ------------------------------------------------------------------ Adam

def adam_init(params):
    names = leaf_order(params)
    dev = params[names[0]].device if names else None

    def z(n):
        return torch.zeros(params[n].shape, dtype=torch.float32,
                           device=params[n].device)
    return {"m": {n: z(n) for n in names}, "v": {n: z(n) for n in names},
            "t": torch.zeros((), dtype=torch.int32, device=dev)}


def adam_update(params, grads, state, *, lr, b1=0.9, b2=0.95, eps=1e-8,
                weight_decay=0.0):
    names = leaf_order(params)
    t = state["t"] + 1
    m = {n: b1 * state["m"][n] + (1 - b1) * grads[n].float() for n in names}
    v = {n: b2 * state["v"][n] + (1 - b2) * torch.square(grads[n].float())
         for n in names}
    mh = 1.0 - b1 ** t.float()
    vh = 1.0 - b2 ** t.float()

    def upd(n):
        step = (m[n] / mh) / (torch.sqrt(v[n] / vh) + eps)
        if weight_decay:
            step = step + weight_decay * params[n].float()
        return (params[n].float() - lr * step).to(params[n].dtype)

    return {n: upd(n) for n in names}, {"m": m, "v": v, "t": t}
