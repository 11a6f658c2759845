"""Recurrent sequence mixers: the LSTM / biLSTM of the paper's AM.

The recurrence is a Python loop over time of plain tensor ops (the
reference's ``lax.scan``).  The input projection ``x @ wx + b`` of every
step is taken up front in one matrix product; each step (``_step``, the
body of ``lstm_cell`` too) then adds ``h @ wh`` and applies the gates.  The forget bias ``+1.0`` sits inside
the sigmoid, ``c`` is carried in float32 and ``h`` in the input dtype.

Params are mappings ``{"wx": (D_in, 4H), "wh": (H, 4H), "b": (4H,)}``,
applied as ``x @ wx`` with gates in i, f, g, o order.
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch

from repro_torch.models import layers


def init_lstm(d_in: int, d_h: int, *, generator: torch.Generator,
              device="cpu"):
    return {"wx": layers.dense_init(d_in, 4 * d_h, generator=generator,
                                    device=device),
            "wh": layers.dense_init(d_h, 4 * d_h, generator=generator,
                                    device=device),
            "b": torch.zeros((4 * d_h,), dtype=torch.float32,
                             device=device)}


def _step(xw_t: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
          wh: torch.Tensor):
    """One step from the projected input ``xw_t = x_t @ wx + b``."""
    i, f, g, o = torch.addmm(xw_t, h, wh).float().chunk(4, dim=-1)
    c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    h2 = torch.sigmoid(o) * torch.tanh(c)
    return h2.to(xw_t.dtype), c


def lstm_cell(params: Mapping[str, torch.Tensor], x_t, h, c):
    """x_t (B, D_in), h (B, H), c (B, H) f32 -> (h, c): the step
    ``lstm_apply`` runs at every time step."""
    dt = x_t.dtype
    xw_t = torch.addmm(params["b"].to(dt), x_t, params["wx"].to(dt))
    return _step(xw_t, h, c, params["wh"].to(dt))


def lstm_apply(params: Mapping[str, torch.Tensor], x: torch.Tensor,
               state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               lens: Optional[torch.Tensor] = None):
    """x (B,S,D) -> ((B,S,H), (h, c)).  state: optional carried (h, c).

    lens (B,) optional valid lengths: the carried (h, c) freezes once a
    row passes its length, so a padded batch hands back exactly the state
    an unpadded per-row run would.  The per-step output is the unfrozen
    ``h``; outputs past a row's length are unspecified — callers mask or
    slice them.
    """
    b, s, _ = x.shape
    dt = x.dtype
    wh = params["wh"].to(dt)
    d_h = wh.shape[0]
    if state is None:
        h = torch.zeros((b, d_h), dtype=dt, device=x.device)
        c = torch.zeros((b, d_h), dtype=torch.float32, device=x.device)
    else:
        h, c = state
    xw = torch.addmm(params["b"].to(dt), x.reshape(b * s, -1),
                     params["wx"].to(dt)).reshape(b, s, -1)
    mask = None
    if lens is not None:
        mask = (torch.arange(s, device=x.device)[None, :]
                < lens.to(x.device)[:, None])[..., None]      # (B,S,1)
    ys = []
    for t in range(s):
        h2, c2 = _step(xw[:, t], h, c, wh)
        if mask is None:
            h, c = h2, c2
        else:
            h = torch.where(mask[:, t], h2, h)
            c = torch.where(mask[:, t], c2, c)
        ys.append(h2)
    return torch.stack(ys, dim=1), (h, c)


def masked_reverse(x: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Reverse each row's first lens[b] steps along time; zero the tail.

    x (B,S,...), lens (B,) -> same shape.  An involution on the valid
    region (runs a biLSTM's backward LSTM over ragged batches without
    reading padding).
    """
    s = x.shape[1]
    ar = torch.arange(s, device=x.device)
    lens = lens.to(x.device, torch.int64)
    idx = (lens[:, None] - 1 - ar[None, :]).clamp(0, s - 1)       # (B,S)
    tail = (1,) * (x.dim() - 2)
    rev = torch.gather(x, 1, idx.reshape(idx.shape + tail).expand_as(x))
    mask = (ar[None, :] < lens[:, None]).reshape(x.shape[:2] + tail)
    return torch.where(mask, rev, torch.zeros((), dtype=x.dtype,
                                              device=x.device))


def bilstm_apply(fwd_params, bwd_params, x: torch.Tensor,
                 lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Bidirectional LSTM: concat([fwd, bwd]) on the last axis.  With
    lens, the backward pass starts at each row's last *valid* frame, so
    padded batches match per-row runs on the valid region."""
    if lens is None:
        yf, _ = lstm_apply(fwd_params, x)
        yb, _ = lstm_apply(bwd_params, x.flip(1))
        return torch.cat([yf, yb.flip(1)], dim=-1)
    yf, _ = lstm_apply(fwd_params, x, lens=lens)
    yb, _ = lstm_apply(bwd_params, masked_reverse(x, lens), lens=lens)
    return torch.cat([yf, masked_reverse(yb, lens)], dim=-1)
