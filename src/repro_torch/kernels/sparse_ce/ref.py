"""Plain PyTorch versions of the fused logsumexp + top-k gather.

``sparse_ce_lse_gather_ref`` materializes the (T, V) logits once -- the
thing the kernel exists to avoid.  On a CPU tensor the autograd function
of ``ops.py`` runs it in place of the kernel; ``chip_smoke.py`` holds the
CUDA kernel against it on the card.  ``sparse_ce_tiled_ref`` is the CUDA
kernel's arithmetic on the host (3xTF32 split, accumulator grouping over
D, per-tile partials and their merge); no model path calls it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._tf32 import tf32_split

NEG = -1e30
V_TILE = 128         # vocab columns of a block's tile (kBV)
WARP_COLS = 16       # a tile's columns a warp reduces (8 lanes x 2)
D_CHUNK = 32         # depth of one fresh big.big accumulator (kBK)
K_STEP = 8           # depth of one wgmma k-step
MERGE_LANES = 32     # the merge's lanes (a warp per row)


def sparse_ce_lse_gather_ref(h: torch.Tensor, w: torch.Tensor,
                             idx: torch.Tensor, *, softcap: float = 0.0):
    """h (T,D), w (D,V), idx (T,K) -> (lse (T,), gathered (T,K)) f32."""
    logits = h.float() @ w.float()
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    lse = torch.logsumexp(logits, dim=-1)
    return lse, torch.gather(logits, -1, idx.long())


def _tree(x: torch.Tensor, *, halves: bool) -> torch.Tensor:
    """Sum over the last axis (a power of two long) as a shuffle-xor
    butterfly adds it for its first lane: neighbours first (offsets
    rising), or the two halves first (offsets falling)."""
    while x.shape[-1] > 1:
        n = x.shape[-1] // 2
        x = x[..., :n] + x[..., n:] if halves else \
            x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def sparse_ce_tiled_ref(h: torch.Tensor, w: torch.Tensor,
                        idx: torch.Tensor, *, softcap: float = 0.0):
    """The Hopper kernel's schedule in plain PyTorch: h (T,D), w (D,V),
    idx (T,K) -> (lse (T,), gathered (T,K)) f32.

    Both operands split as 3xTF32 (``tf32_split``: the kernel's
    ``cvt.rna``); big.big in a fresh sum for each ``D_CHUNK``-deep chunk
    of D, added to the running logits; the small terms in one sum over all
    of D, small.big then big.small for each ``K_STEP`` of depth, added
    last; softcap; columns past V masked to NEG in ``V_TILE``-column
    tiles.  Each tile's partial as the kernel's epilogue takes it: a
    warp's ``WARP_COLS`` columns (lane g holds columns g and g + 8) give
    (max, sum of exp(x - max)), the pair's two terms added per lane and
    the 8 lanes' sums in a butterfly, neighbours first; the tile's 8 warps
    merged in warp order into (m_j, l_j).  The merge as the kernel's warp
    takes it (lane i sums l_j exp(m_j - m) over tiles j = i mod 32 in
    order, then the butterfly over the lanes, halves first) and lse = m +
    log(max(l, 1e-30)); ids
    outside [0, V) gather NEG.  The tests hold it against the reference
    to show, on the host, that the split and the grouping meet float32's
    bar.
    """
    t, d = h.shape
    v = w.shape[1]
    hb, hs = tf32_split(h.float())
    wb, ws = tf32_split(w.float())
    run = torch.zeros((t, v), dtype=torch.float32, device=h.device)
    small = torch.zeros_like(run)
    for k0 in range(0, d, D_CHUNK):
        c = slice(k0, k0 + D_CHUNK)
        run = run + hb[:, c] @ wb[c]
        for j0 in range(k0, min(k0 + D_CHUNK, d), K_STEP):
            s = slice(j0, j0 + K_STEP)
            small = small + hb[:, s] @ ws[s]
            small = small + hs[:, s] @ wb[s]
    run = run + small
    if softcap:
        run = torch.tanh(run / softcap) * softcap
    n_vt = -(-v // V_TILE)
    full = torch.full((t, n_vt * V_TILE), NEG, dtype=torch.float32,
                      device=h.device)
    full[:, :v] = run
    n_w = V_TILE // WARP_COLS
    # (T, tile, warp, lane g, column g or g + 8)
    cols = full.reshape(t, n_vt, n_w, 2, WARP_COLS // 2).transpose(-1, -2)
    wm = cols.amax(dim=(-1, -2))
    e = torch.exp(cols - wm[..., None, None])
    wl = _tree(e[..., 0] + e[..., 1], halves=False)
    pm = wm.amax(dim=-1)
    pl = torch.zeros_like(pm)
    for q in range(n_w):
        pl = pl + wl[..., q] * torch.exp(wm[..., q] - pm)
    m = pm.max(dim=-1).values
    lanes = torch.zeros((t, MERGE_LANES), dtype=torch.float32,
                        device=h.device)
    for j in range(n_vt):
        lanes[:, j % MERGE_LANES] += pl[:, j] * torch.exp(pm[:, j] - m)
    l = _tree(lanes, halves=True)
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    ids = idx.long()
    inside = (ids >= 0) & (ids < v)
    z = torch.where(inside, full.gather(1, ids.clamp(0, v - 1)),
                    torch.full_like(run[:, :1], NEG))
    return lse, z


def topk_distill_ce_ref(h, w, topk_vals, topk_idx, *, softcap: float = 0.0):
    """The paper's SSL loss from the full-logit primitive."""
    lse, z = sparse_ce_lse_gather_ref(h, w, topk_idx, softcap=softcap)
    q = torch.softmax(topk_vals.float(), dim=-1)
    return torch.mean(torch.sum(q * (lse[:, None] - z), dim=-1))
