"""Plain PyTorch version of causal sliding-window attention, with the
full (S, S) mask: the twin of the reference's
``kernels/swa_attention/ref.py``.  The tests use it, and
``chip_smoke.py`` holds the kernel against it on the card; no model path
calls it (on the host, ``models/attention.py`` runs the chunked twins of
the reference's XLA path instead).

Beside it, the kernel's arithmetic on the host:
``swa_attention_tiled_ref``, the kernel's schedule with its 3xTF32
products (split by ``kernels/_tf32.py``).  Only the tests call it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels._tf32 import tf32_split

NEG = -1e30


def visible(s: int, window: int, positions=None, *, device=None):
    """The (S, S) bool mask of the keys each query sees.  By index (no
    ``positions``): key j is visible to query i iff ``i - window < j <=
    i``.  With ``positions`` (S,) int, the causal branch only (window >=
    S): iff ``pos[i] >= 0 and pos[j] <= pos[i]``, the mask of the
    reference's ``flash_full_attention`` (``models/attention.py``)."""
    if positions is not None:
        if window < s:
            raise ValueError(f"positions mask the causal branch only "
                             f"(window >= S); got window {window} < S {s}")
        p = positions.to(device).long()
        return (p[:, None] >= 0) & (p[None, :] <= p[:, None])
    i = torch.arange(s, device=device)[:, None]
    j = torch.arange(s, device=device)[None, :]
    return (j <= i) & (i - j < window)


def swa_attention_ref(q, k, v, window: int, *, softcap: float = 0.0,
                      positions=None):
    """q (B,H,S,hd); k/v (B,H,S,hd) (GQA pre-broadcast upstream).

    Causal + window: key j visible to query i iff  i - window < j <= i;
    with ``positions`` (S,) int (window >= S only) iff pos[i] >= 0 and
    pos[j] <= pos[i].  A row that sees no key (pos[i] < 0) gets the mean
    of v over the S keys: every score is the same -1e30.
    Returns (B,H,S,hd) f32.
    """
    b, h, s, hd = q.shape
    scale = 1.0 / np.sqrt(hd)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    mask = visible(s, window, positions, device=q.device)
    logits = torch.where(mask[None, None], logits, NEG)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float())


# ----------------------------------------------------- the kernel's schedule

Q_TILE = 64                                   # query rows a block (kTq)
TILES = {64: 32, 120: 32, 128: 32, 256: 8}    # padded hd -> keys a tile


def padded_head_dim(hd: int) -> int:
    """The head dim the kernel's tiles are built for (``padded_hd`` in
    the source): hd rounded up to 64, 120, 128 or 256."""
    return next(p for p in sorted(TILES) if hd <= p)


def _scores3(q, kt, hdp: int):
    """q @ kt as the kernel's 3xTF32 scores: the small terms
    (small.big + big.small) and the two halves of big.big over the
    padded head dim ``hdp`` in three sums, added as (half 0 + small) +
    half 1."""
    qb, qs = tf32_split(q)
    kb, ks = tf32_split(kt)
    h = hdp // 16 * 8                 # the first half's k-steps of 8
    small = qs @ kb + qb @ ks
    return (qb[..., :h] @ kb[..., :h, :] + small) + \
        qb[..., h:] @ kb[..., h:, :]


def _pv3(p, v):
    """p @ v as the kernel's 3xTF32 tile product: small.big + big.small +
    big.big in one sum, the small terms first."""
    pb, ps = tf32_split(p)
    vb, vs = tf32_split(v)
    return (ps @ vb + pb @ vs) + pb @ vb


def swa_attention_tiled_ref(q, k, v, window: int, *, softcap: float = 0.0,
                            positions=None):
    """The Hopper kernel's schedule in plain PyTorch: q (B,Hq,S,hd), k/v
    (B,Hkv,S,hd) read by index (query head h reads kv head h // G).
    With ``positions`` (window >= S): every key tile, the positions'
    mask, and the keys past S of the last tile at -inf.

    For each tile of ``Q_TILE`` query rows, the key tiles of
    ``TILES[padded_head_dim(hd)]`` keys that hold its band [q0 - window
    + 1, q0 + Q_TILE), in order; the band's first tile's keys before the
    band carry v = 0; scores as 3xTF32 in three sums (``_scores3``);
    scale, softcap, then the -1e30 mask; the online softmax in the
    kernel's order (tile max, correction, tile sum), o = o * corr + the
    tile's 3xTF32 p.v (``_pv3``), and o / max(l, 1e-30).  Returns
    (B,Hq,S,hd) f32.  No model path calls it: the tests hold it against
    the reference to show, on the host, that the split meets float32's
    bar.
    """
    b, hq, s, hd = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    hdp = padded_head_dim(hd)
    tk = TILES[hdp]
    scale = float(np.float32(1.0 / np.sqrt(hd)))
    qf = q.float().reshape(b, hkv, g, s, hd)
    kf, vf = k.float(), v.float()
    out = torch.empty((b, hkv, g, s, hd), dtype=torch.float32,
                      device=q.device)
    for q0 in range(0, s, Q_TILE):
        rows = torch.arange(q0, min(s, q0 + Q_TILE), device=q.device)
        k_lo, k_hi = max(0, q0 - window + 1), min(s, q0 + Q_TILE)
        if positions is not None:
            k_lo, k_hi = 0, s
        qt = qf[:, :, :, rows]                          # (B,Hkv,G,n,hd)
        m = torch.full(qt.shape[:-1], NEG, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        o = torch.zeros(qt.shape, dtype=torch.float32, device=q.device)
        for k0 in range(k_lo // tk * tk, k_hi, tk):
            cols = torch.arange(k0, min(s, k0 + tk), device=q.device)
            kt = kf[:, :, None, cols]                   # (B,Hkv,1,n,hd)
            vt = torch.where((cols < k_lo)[:, None], 0.0,
                             vf[:, :, None, cols])
            pad = k0 + tk - s        # the tile's keys past S (k = v = 0)
            if positions is not None and pad > 0:
                cols = torch.cat([cols, torch.arange(s, k0 + tk,
                                                     device=q.device)])
                zero = kt.new_zeros(kt.shape[:-2] + (pad, hd))
                kt = torch.cat([kt, zero], dim=-2)
                vt = torch.cat([vt, zero.expand(vt.shape[:-2] + (pad, hd))],
                               dim=-2)
            x = _scores3(qt, kt.transpose(-1, -2), hdp) * scale
            if softcap:
                x = torch.tanh(x / softcap) * softcap
            if positions is None:
                vis = (cols[None, :] <= rows[:, None]) & \
                    (rows[:, None] - cols[None, :] < window)
                x = torch.where(vis, x, NEG)
            else:
                pos = positions.to(q.device).long()
                inside = cols < s
                pj = pos[cols.clamp(max=s - 1)]
                pi = pos[rows][:, None]
                vis = inside[None, :] & (pi >= 0) & (pj[None, :] <= pi)
                x = torch.where(vis, x, torch.where(inside, NEG,
                                                    -float("inf")))
            m_new = torch.maximum(m, x.max(dim=-1).values)
            corr = torch.exp(m - m_new)
            p = torch.exp(x - m_new[..., None])
            l = l * corr + p.sum(dim=-1)
            m = m_new
            o = o * corr[..., None] + _pv3(p, vt)
        out[:, :, :, rows] = o / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, hq, s, hd)
