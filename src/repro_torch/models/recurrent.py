"""Recurrent sequence mixers: the LSTM / biLSTM of the paper's AM,
RG-LRU (RecurrentGemma / Griffin), mLSTM and sLSTM (xLSTM).

Every recurrence is plain tensor ops, as the reference's is plain XLA:

  * LSTM and sLSTM: a Python loop over time (the reference's
    ``lax.scan``).  The LSTM's input projection ``x @ wx + b`` of every
    step is taken up front in one matrix product; each step (``_step``,
    the body of ``lstm_cell`` too) then adds ``h @ wh`` and applies the
    gates.  The forget bias ``+1.0`` sits inside the sigmoid, ``c`` is
    carried in float32 and ``h`` in the input dtype.
  * RG-LRU: the linear recurrence ``h_t = a_t h_{t-1} + b_t`` as a
    log-depth scan in tensor ops over the reference's ``combine`` (the
    reference's ``lax.associative_scan``): ceil(log2 S) doubling passes
    over the whole sequence, so a prefill takes no Python loop of S
    steps.  Its rounding is not XLA's; the tests hold it to the
    reference within a stated tolerance.
  * mLSTM: one sequential loop over time whatever ``chunk`` says (the
    reference's chunking only decides what its backward keeps).

Decode forms take one step over an explicit state dict; its recurrent
leaves are float32, its conv tail in the input dtype.  Softplus and
log-sigmoid are ``F.softplus`` and ``F.logsigmoid``: the reference's
``logaddexp`` forms, one op each, each with its own last bit.

Params are mappings named after the reference's param tree, applied as
``x @ w``: the LSTM's ``{"wx": (D_in, 4H), "wh": (H, 4H), "b": (4H,)}``
with gates in i, f, g, o order; the mixers' leaves as ``init_*`` lay
them out.
"""
from __future__ import annotations

import math
from typing import Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

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


# ================================================================ helpers

def _normal_over(shape, fan: int, *, generator, device):
    """``shape`` ~ N(0, 1/fan), scaled where drawn (as
    ``layers.dense_init``); a shape template without a generator."""
    if generator is None:
        return layers._normal(shape, None, device)
    w = layers._normal(shape, generator, generator.device)
    return (w / math.sqrt(fan)).to(device)


def _causal_conv(x: torch.Tensor, kernel: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv along time. x (B,S,W), kernel (K,W).

    state (B,K-1,W) holds the trailing context (decode, or a prefill
    that continues); returns (y, new_state), the new state the last K-1
    rows of the padded input."""
    k = kernel.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    s = x.shape[1]
    kernel = kernel.to(x.dtype)
    if s == 1:                  # a decode step: one product, one sum
        y = (xp * kernel).sum(dim=1, keepdim=True)
    else:
        y = xp[:, :s, :] * kernel[0]
        for i in range(1, k):
            y = y + xp[:, i:i + s, :] * kernel[i]
    new_state = xp[:, -(k - 1):, :] if k > 1 else None
    return y, new_state


# ================================================================= RG-LRU

def init_rglru_block(cfg, *, generator: Optional[torch.Generator],
                     device="cpu"):
    """Griffin recurrent block: in/gate proj -> conv -> RG-LRU -> out
    proj.  ``lam`` is softplus^-1 of linspace(2, 6), the reference's
    spread of decay rates."""
    d, w = cfg.d_model, cfg.lru_width or cfg.d_model
    kw = dict(generator=generator, device=device)
    lam = np.log(np.expm1(np.linspace(2.0, 6.0, w, dtype=np.float32)))
    return {
        "w_in": layers.dense_init(d, w, **kw),
        "w_gate": layers.dense_init(d, w, **kw),
        "conv": _normal_over((cfg.conv_width, w), cfg.conv_width, **kw),
        "w_a": layers.dense_init(w, w, scale=0.5, **kw),
        "w_i": layers.dense_init(w, w, scale=0.5, **kw),
        "lam": torch.from_numpy(lam).to(device),
        "w_out": layers.dense_init(w, d, **kw),
    }


def _rglru_coeffs(params, x: torch.Tensor):
    """Per-step decay a_t and gated input b_t, float32."""
    xf = x.float()
    r = torch.sigmoid(xf @ params["w_a"])
    i = torch.sigmoid(xf @ params["w_i"])
    log_a = -8.0 * r * F.softplus(params["lam"])         # log a_t <= 0
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                   min=1e-12)) * (i * xf)
    return a, gated


def rglru_scan(params, x: torch.Tensor,
               h0: Optional[torch.Tensor] = None):
    """Linear recurrence h_t = a_t h_{t-1} + b_t over x (B,S,W), as a
    Hillis-Steele scan of ``combine((a_l, b_l), (a_r, b_r)) = (a_l a_r,
    a_r b_l + b_r)``: pass d combines each step with the one d earlier,
    d = 1, 2, 4, ...  ``h0`` (B,W) folds into the first input.  Returns
    (h (B,S,W) in x's dtype, h_last (B,W) float32)."""
    a, b = _rglru_coeffs(params, x)
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0.float()[:, None], b[:, 1:]],
                      dim=1)
    s = x.shape[1]
    d = 1
    while d < s:
        a_l, b_l = a[:, :-d], b[:, :-d]
        a_r, b_r = a[:, d:], b[:, d:]
        a = torch.cat([a[:, :d], a_l * a_r], dim=1)
        b = torch.cat([b[:, :d], a_r * b_l + b_r], dim=1)
        d *= 2
    return b.to(x.dtype), b[:, -1]


def rglru_block_apply(params, cfg, x: torch.Tensor, state=None):
    """x (B,S,D) -> (y (B,S,D), state); state = {"h": (B,W) f32,
    "conv": (B,K-1,W)}, or None to start from zeros."""
    gate = layers.act_fn("gelu")(x @ params["w_gate"].to(x.dtype))
    u = x @ params["w_in"].to(x.dtype)
    u, conv_state = _causal_conv(u, params["conv"],
                                 None if state is None else state["conv"])
    h, h_last = rglru_scan(params, u, None if state is None else state["h"])
    y = (h * gate) @ params["w_out"].to(x.dtype)
    return y, {"h": h_last, "conv": conv_state}


def rglru_block_decode(params, cfg, x: torch.Tensor, state):
    """One step. x (B,1,D) -> (y (B,1,D), state)."""
    gate = layers.act_fn("gelu")(x @ params["w_gate"].to(x.dtype))
    u = x @ params["w_in"].to(x.dtype)
    u, conv_state = _causal_conv(u, params["conv"], state["conv"])
    a, b = _rglru_coeffs(params, u)
    h = a[:, 0] * state["h"] + b[:, 0]
    y = (h[:, None].to(x.dtype) * gate) @ params["w_out"].to(x.dtype)
    return y, {"h": h, "conv": conv_state}


def init_rglru_state(cfg, batch: int, dtype, *, device="cpu"):
    w = cfg.lru_width or cfg.d_model
    return {"h": torch.zeros((batch, w), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype,
                                device=device)}


# ================================================================== mLSTM

def init_mlstm_block(cfg, *, generator: Optional[torch.Generator],
                     device="cpu"):
    d = cfg.d_model
    inner = int(cfg.mlstm_proj_factor * d)
    h = cfg.n_heads
    kw = dict(generator=generator, device=device)
    return {
        "w_up": layers.dense_init(d, inner, **kw),
        "w_gate": layers.dense_init(d, inner, **kw),
        "conv": _normal_over((cfg.conv_width, inner), cfg.conv_width,
                             **kw),
        "wq": layers.dense_init(inner, inner, **kw),
        "wk": layers.dense_init(inner, inner, **kw),
        "wv": layers.dense_init(inner, inner, **kw),
        "w_if": layers.dense_init(inner, 2 * h, **kw),   # i, f gate logits
        "b_if": torch.cat([torch.zeros((h,)), 3.0 * torch.ones((h,))]
                          ).to(device),
        "gn": torch.ones((inner,), device=device),      # group-norm scale
        "w_down": layers.dense_init(inner, d, **kw),
    }


def _mlstm_qkv(params, cfg, x: torch.Tensor, conv_state=None):
    """x (B,S,D) -> q, k, v (B,H,S,hd), gate logits (B,S,2H) f32, the up
    projection u and the conv state.  q and k are both scaled by
    1/sqrt(hd); v comes from u, before the conv and the SiLU."""
    u = x @ params["w_up"].to(x.dtype)
    c, conv_state = _causal_conv(u, params["conv"], conv_state)
    c = F.silu(c)
    b, s, inner = c.shape
    h = cfg.n_heads
    hd = inner // h

    def heads(m):
        return m.reshape(b, s, h, hd).transpose(1, 2)
    scale = float(np.sqrt(hd))
    q = heads(c @ params["wq"].to(x.dtype)) / scale
    k = heads(c @ params["wk"].to(x.dtype)) / scale
    v = heads(u @ params["wv"].to(x.dtype))
    gates = (c @ params["w_if"].to(x.dtype)).float() + params["b_if"]
    return q, k, v, gates, u, conv_state


MLSTM_CHUNK = 64     # the reference's remat chunk: it decides only what
                     # the reference's backward keeps, not the values


def _mlstm_loop(q, k, v, i_log, f_log, C, n, m):
    """The stabilised mLSTM over S steps from (C, n, m): q/k/v
    (B,H,S,hd), the gate logits (B,H,S) (f already log-sigmoid).  The
    stabiliser m_t = max(f_t + m_{t-1}, i_t) is a loop of its own over
    (B,H) scalars; the gates exp(i_t - m_t) and exp(f_t + m_{t-1} - m_t)
    of every step then come in one op each, and the memory loop is
    C_t = f C_{t-1} + i v_t k_t^T, n_t = f n_{t-1} + i k_t and C_t q_t.
    The denominator max(|n_t . q_t|, exp(-m_t)) and h of every step come
    after the loop.  Each value is the reference's step's, op for op.
    Returns h (B,H,S,hd) float32 and the final (C, n, m)."""
    s = q.shape[2]
    fms, ms = [], []
    for t in range(s):
        fm = f_log[..., t] + m
        m = torch.maximum(fm, i_log[..., t])
        fms.append(fm)
        ms.append(m)
    m_all = _stack(ms, -1)                               # (B,H,S)
    i_all = torch.exp(i_log - m_all).permute(2, 0, 1)[..., None]
    f_all = torch.exp(_stack(fms, -1) - m_all).permute(
        2, 0, 1)[..., None]                              # (S,B,H,1)
    qs, ks, vs = (a.float().permute(2, 0, 1, 3) for a in (q, k, v))
    nums, ns = [], []
    for t in range(s):
        C = f_all[t, ..., None] * C + i_all[t, ..., None] * (
            vs[t][..., :, None] * ks[t][..., None, :])
        n = f_all[t] * n + i_all[t] * ks[t]
        nums.append(torch.matmul(C, qs[t][..., None])[..., 0])
        ns.append(n)
    q = q.float()
    nq = (_stack(ns, 2) * q).sum(-1)                     # (B,H,S)
    den = torch.maximum(torch.abs(nq), torch.exp(-m_all))[..., None]
    return _stack(nums, 2) / den, (C, n, m)


def _stack(xs, dim: int) -> torch.Tensor:
    """``torch.stack``, a view for one tensor (a decode step)."""
    return xs[0].unsqueeze(dim) if len(xs) == 1 else torch.stack(xs, dim)


def _mlstm_gates(gates, h: int):
    """Gate logits (B,S,2H) -> i (B,H,S) and log-sigmoid f (B,H,S)."""
    return (gates[..., :h].transpose(1, 2),
            F.logsigmoid(gates[..., h:]).transpose(1, 2))


def mlstm_scan(q, k, v, gates, *, chunk: int = MLSTM_CHUNK):
    """Sequential stabilised mLSTM from a zero state. q/k/v (B,H,S,hd);
    gates (B,S,2H).  One loop over S whatever ``chunk`` is: the
    reference's chunked form (``chunk``) only decides what its backward
    keeps, and its values are the flat scan's.  Returns h (B,H,S,hd) and
    the final state (C, n, m)."""
    del chunk
    b, h, _, hd = q.shape
    dev = q.device
    C0 = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=dev)
    n0 = torch.zeros((b, h, hd), dtype=torch.float32, device=dev)
    m0 = torch.zeros((b, h), dtype=torch.float32, device=dev)
    return _mlstm_loop(q, k, v, *_mlstm_gates(gates, h), C0, n0, m0)


def _mlstm_with_state(q, k, v, gates, state):
    """A prefill that continues from ``state`` (its C, n, m)."""
    hs, (C, n, m) = _mlstm_loop(q, k, v, *_mlstm_gates(gates, q.shape[1]),
                                state["C"], state["n"], state["m"])
    return hs, {"C": C, "n": n, "m": m, "conv": state["conv"]}


def _groupnorm(x: torch.Tensor, scale: torch.Tensor, n_groups: int,
               eps: float = 1e-6) -> torch.Tensor:
    """Head-wise group norm over the channel axis (population variance,
    rsqrt). x (B,S,C)."""
    b, s, cdim = x.shape
    xf = x.float().reshape(b, s, n_groups, cdim // n_groups)
    d = xf - xf.mean(dim=-1, keepdim=True)
    y = d * torch.rsqrt(d.square().mean(dim=-1, keepdim=True) + eps)
    return (y.reshape(b, s, cdim) * scale).to(x.dtype)


def _mlstm_out(params, cfg, x, hvec):
    """Group norm of h (B,S,inner), the SiLU gate from x, down proj."""
    y = _groupnorm(hvec, params["gn"], cfg.n_heads)
    gate = F.silu(x @ params["w_gate"].to(x.dtype))
    return (y.to(x.dtype) * gate) @ params["w_down"].to(x.dtype)


def mlstm_block_apply(params, cfg, x: torch.Tensor, state=None):
    """x (B,S,D) -> (y, state {"C", "n", "m", "conv"})."""
    q, k, v, gates, _, conv_state = _mlstm_qkv(
        params, cfg, x, None if state is None else state["conv"])
    if state is not None:
        hseq, st = _mlstm_with_state(q, k, v, gates, state)
        st["conv"] = conv_state
    else:
        hseq, (C, n, m) = mlstm_scan(q, k, v, gates)
        st = {"C": C, "n": n, "m": m, "conv": conv_state}
    b, h, s, hd = hseq.shape
    y = hseq.transpose(1, 2).reshape(b, s, h * hd)
    return _mlstm_out(params, cfg, x, y), st


def mlstm_block_decode(params, cfg, x: torch.Tensor, state):
    """x (B,1,D); one recurrent step."""
    u = x @ params["w_up"].to(x.dtype)
    c, conv_state = _causal_conv(u, params["conv"], state["conv"])
    c = F.silu(c)
    b, _, inner = c.shape
    h = cfg.n_heads
    hd = inner // h
    scale = float(np.sqrt(hd))
    q = (c @ params["wq"].to(x.dtype)).reshape(b, h, 1, hd).float() / scale
    k = (c @ params["wk"].to(x.dtype)).reshape(b, h, 1, hd).float() / scale
    v = (u @ params["wv"].to(x.dtype)).reshape(b, h, 1, hd).float()
    gl = (c @ params["w_if"].to(x.dtype)).float() + params["b_if"]
    hvec, (C, n, m) = _mlstm_loop(q, k, v, *_mlstm_gates(gl, h),
                                  state["C"], state["n"], state["m"])
    y = _mlstm_out(params, cfg, x, hvec.reshape(b, 1, inner))
    return y, {"C": C, "n": n, "m": m, "conv": conv_state}


def init_mlstm_state(cfg, batch: int, dtype, *, device="cpu"):
    inner = int(cfg.mlstm_proj_factor * cfg.d_model)
    h = cfg.n_heads
    hd = inner // h
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, h, hd, hd), **f32),
            "n": torch.zeros((batch, h, hd), **f32),
            "m": torch.zeros((batch, h), **f32),
            "conv": torch.zeros((batch, cfg.conv_width - 1, inner),
                                dtype=dtype, device=device)}


# ================================================================== sLSTM

def init_slstm_block(cfg, *, generator: Optional[torch.Generator],
                     device="cpu"):
    d = cfg.d_model
    h = cfg.n_heads
    hd = d // h
    kw = dict(generator=generator, device=device)
    return {
        "conv": _normal_over((cfg.conv_width, d), cfg.conv_width, **kw),
        "wx": layers.dense_init(d, 4 * d, **kw),
        # block-diagonal recurrent weights: per head (hd x 4hd)
        "rh": _normal_over((h, hd, 4 * hd), hd, **kw),
        "b": torch.zeros((4 * d,), device=device),
        "gn": torch.ones((d,), device=device),
        # the sLSTM block's own gated MLP, added inside the mixer
        "mlp": layers.mlp_init(d, int(cfg.slstm_proj_factor * d),
                               gated=True, **kw),
    }


def _slstm_gates(params, cfg, xz: torch.Tensor, hprev: torch.Tensor):
    """xz (B,4D) the precomputed input part; hprev (B,D).  The recurrent
    part is one batched product over the heads' diagonal blocks.
    Returns the i, f, z, o logits, each (B,D)."""
    b, d4 = xz.shape
    d = d4 // 4
    h = cfg.n_heads
    rec = torch.bmm(hprev.reshape(b, h, d // h).transpose(0, 1),
                    params["rh"]).transpose(0, 1).reshape(b, 4 * d)
    z = xz + rec + params["b"]
    return z.chunk(4, dim=-1)


def slstm_block_apply(params, cfg, x: torch.Tensor, state=None):
    """x (B,S,D) -> (y, state {"c", "n", "m", "h", "conv"}).  The forget
    logit enters raw (no log-sigmoid); y is the group-normed h plus the
    block's gated GELU MLP of it."""
    b, s, d = x.shape
    c_in, conv_state = _causal_conv(x, params["conv"],
                                    None if state is None else state["conv"])
    c_in = F.silu(c_in)
    xz = (c_in @ params["wx"].to(x.dtype)).float()
    st = init_slstm_state(cfg, b, x.dtype, device=x.device) \
        if state is None else state
    c, n, m, hv = st["c"], st["n"], st["m"], st["h"]
    hs = []
    for t in range(s):
        il, fl, zl, ol = _slstm_gates(params, cfg, xz[:, t], hv)
        fm = fl + m
        m_new = torch.maximum(fm, il)
        i_ = torch.exp(il - m_new)
        f_ = torch.exp(fm - m_new)
        c = f_ * c + i_ * torch.tanh(zl)
        n = f_ * n + i_
        m = m_new
        hv = torch.sigmoid(ol) * c / torch.clamp(n, min=1e-6)
        hs.append(hv)
    y = _groupnorm(torch.stack(hs, dim=1), params["gn"],
                   cfg.n_heads).to(x.dtype)
    y = y + layers.mlp_apply(params["mlp"], y, "gelu")
    return y, {"c": c, "n": n, "m": m, "h": hv, "conv": conv_state}


def slstm_block_decode(params, cfg, x: torch.Tensor, state):
    """One step: ``slstm_block_apply`` at S = 1 from ``state``."""
    return slstm_block_apply(params, cfg, x, state)


def init_slstm_state(cfg, batch: int, dtype, *, device="cpu"):
    d = cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, d), **f32),
            "n": torch.zeros((batch, d), **f32),
            "m": torch.zeros((batch, d), **f32),
            "h": torch.zeros((batch, d), **f32),
            "conv": torch.zeros((batch, cfg.conv_width - 1, d), dtype=dtype,
                                device=device)}
