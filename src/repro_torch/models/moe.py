"""Mixture-of-Experts channel mixer with capacity-based sort dispatch.

The twin of the reference's ``models/moe.py``: router logits in float32,
softmax, top-k (renormalised with a 1e-9 floor when
``cfg.moe_renorm_topk``), then GShard-style grouped dispatch.  Each batch
row is its own routing group with capacity ``capacity(S, cfg)``; inside a
group the flattened (token, k) expert ids are sorted stably, an
assignment's position is its rank within its expert in that order, and
it is kept iff that position is below the capacity.  A dropped
assignment adds nothing (it falls back to the residual path).  Per-row
groups keep rows independent: a row's output never depends on the other
rows, which the continuous batcher's row reset relies on.

The experts apply SiLU whatever ``cfg.act`` says, as the reference's
``_group_dispatch_combine`` does; the shared MLP (``n_shared_experts``)
follows ``cfg.act``.

Two choices of the port, neither changing a value:

  * **Ties go to the smallest expert id**, as ``lax.top_k``'s do: top-k
    is a stable descending sort of the probabilities, cut to k
    (``torch.topk`` promises no order among equal values).
  * **The expert buffer is (E, B*m, D) with m = min(cap, S)**, not the
    reference's per-group (B, E, cap, D).  A token reaches an expert at
    most once, so an expert keeps at most min(cap, S) assignments of a
    group: the bound is exact and static.  A kept assignment of group g
    at position p sits at row g*m + p of its expert; dropped ones go to
    one trash row past the end.  At prefill (S >= cap) m = cap and the
    buffer holds the reference's rows; at decode (S = 1) m = 1, so a
    16-row step multiplies (E, 16, D) rather than 8x as many rows of
    zeros.  Every expert projection is then one ``torch.bmm``.

Every shape follows from (B, S, cfg) alone and no step reads a device
value on the host: the layer adds no sync to a decode window, and it
runs on ``meta`` tensors.

Aux outputs, as the reference computes them over all groups:
``moe_lb_loss`` (E * sum_e f_e P_e, Switch-style), ``moe_z_loss`` (mean
squared logsumexp of the router logits) and ``moe_drop_frac``.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models import layers


def init_moe(cfg, *, generator, device) -> Dict[str, object]:
    """``router`` (D, E) ~ N(0, 0.01 / D), ``w_gate``/``w_up`` (E, D, F)
    ~ N(0, 1 / D), ``w_down`` (E, F, D) ~ N(0, 1 / F), and ``shared``, a
    gated MLP of width ``n_shared_experts * F``, when the config has
    shared experts: the reference's scales."""
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    p = {"router": layers.dense_init(d, e, scale=0.1, generator=generator,
                                     device=device)}
    for name, shape, fan_in in (("w_gate", (e, d, f), d),
                                ("w_up", (e, d, f), d),
                                ("w_down", (e, f, d), f)):
        if generator is None:                 # a meta shape template
            p[name] = layers._normal(shape, None, device)
        else:                     # scaled where drawn, in place: one
            # (E, D, F) buffer at a time (15 GB at deepseek-v3's widths)
            p[name] = layers._normal(shape, generator, generator.device
                                     ).div_(math.sqrt(fan_in)).to(device)
    if cfg.n_shared_experts:
        p["shared"] = layers.mlp_init(d, cfg.n_shared_experts * f,
                                      gated=True, generator=generator,
                                      device=device)
    return p


def capacity(n_tokens: int, cfg) -> int:
    """Per-group expert capacity: ceil(K*N/E * factor), 8-aligned."""
    c = math.ceil(cfg.moe_top_k * n_tokens / cfg.n_experts
                  * cfg.capacity_factor)
    return max(8, ((c + 7) // 8) * 8)          # align to 8


def top_k(probs: torch.Tensor, k: int):
    """(values, int64 ids) of the k largest along the last axis, in
    descending order, equal values in ascending id order (the order of
    ``lax.top_k``)."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def route(params, cfg, x: torch.Tensor):
    """x (B,S,D) -> (logits (T,E) f32, probs (T,E), top_p (T,K), top_i
    (T,K) int64), T = B*S: the router's choice for every token."""
    d = x.shape[-1]
    xt = x.reshape(-1, d)
    logits = (xt @ params["router"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = top_k(probs, cfg.moe_top_k)
    if cfg.moe_renorm_topk:
        top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return logits, probs, top_p, top_i


def _group_dispatch_combine(xg, top_p, top_i, wg, wu, wd, *, cap: int):
    """Every routing group at once: xg (G,N,D); top_* (G,N,K).

    Returns (y (G,N,D), counts (G,E) int64: the assignments each expert
    got in each group, kept or not, dropped (G,) float32: the
    assignments past capacity)."""
    g, n, d = xg.shape
    k = top_i.shape[-1]
    e = wg.shape[0]
    m = min(cap, n)                       # rows an expert keeps a group
    dev = xg.device
    flat_e = top_i.reshape(g, n * k)                          # (G, N*K)
    sort_idx = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, sort_idx)
    counts = torch.zeros((g, e), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, dim=1) - counts
    pos_sorted = (torch.arange(n * k, device=dev)[None, :]
                  - torch.gather(starts, 1, sorted_e))
    pos = torch.empty_like(pos_sorted).scatter_(1, sort_idx, pos_sorted)
    valid = pos < cap
    rows = e * g * m                                          # + 1 trash
    group = torch.arange(g, device=dev)[:, None]
    slot = torch.where(valid, flat_e * (g * m) + group * m + pos,
                       rows).reshape(-1)                      # (G*N*K,)

    # each buffer row's token; rows nothing fills read xz's zero row
    tok = (torch.arange(g * n * k, device=dev) // k)
    src_of_row = torch.full((rows + 1,), g * n, dtype=torch.int64,
                            device=dev).scatter_(0, slot, tok)
    xz = torch.cat([xg.reshape(g * n, d), xg.new_zeros((1, d))])
    buf = xz.index_select(0, src_of_row[:rows]).reshape(e, g * m, d)

    h = F.silu(torch.bmm(buf, wg)) * torch.bmm(buf, wu)
    y_e = torch.bmm(h, wd).reshape(rows, d)

    kept = valid.reshape(-1, 1)
    y_tok = torch.where(
        kept, y_e.index_select(0, slot.clamp(max=rows - 1))
        * top_p.reshape(-1, 1).to(xg.dtype), 0.0)
    y = y_tok.reshape(g, n, k, d).sum(dim=2)
    dropped = (~valid).sum(dim=1).to(torch.float32)
    return y, counts, dropped


def moe_apply(params, cfg, x: torch.Tensor):
    """x (B,S,D) -> (y (B,S,D), aux dict of 0-d float32 tensors).

    Grouped dispatch: each batch row is a routing group with capacity
    ``capacity(S, cfg)``."""
    b, s, d = x.shape
    t = b * s
    k = cfg.moe_top_k
    e = cfg.n_experts
    logits, probs, top_p, top_i = route(params, cfg, x)
    y, counts, dropped = _group_dispatch_combine(
        x, top_p.reshape(b, s, k), top_i.reshape(b, s, k),
        params["w_gate"].to(x.dtype), params["w_up"].to(x.dtype),
        params["w_down"].to(x.dtype), cap=capacity(s, cfg))
    if cfg.n_shared_experts:
        y = y + layers.mlp_apply(params["shared"], x.reshape(t, d),
                                 cfg.act).reshape(b, s, d)

    # ---- aux losses (global across groups) ----
    frac_tokens = counts.sum(dim=0).to(torch.float32) / (t * k)   # f_e
    mean_prob = probs.mean(dim=0)                                  # P_e
    aux = {"moe_lb_loss": e * torch.sum(frac_tokens * mean_prob),
           "moe_z_loss": torch.mean(torch.square(
               torch.logsumexp(logits, dim=-1))),
           "moe_drop_frac": dropped.sum() / (t * k)}
    return y, aux
