"""Plain PyTorch versions of top-k logit selection (paper §3.2.2, k=20).

``topk_logits_ref`` is the whole function; ``topk_logits_tiles_ref`` is
the stage-1 contract of the CUDA kernel (per-tile candidates), laid out
exactly as ``kernel.topk_logits_tiles`` writes them.  The CPU paths and
the tests use these; ``chip_smoke.py`` holds the kernel against them on
the card.
"""
from __future__ import annotations

import torch

NEG = -3.4e38          # ~f32 min: pads tiles and masks extracted candidates


def topk_logits_ref(logits: torch.Tensor, k: int):
    """logits (..., V) -> (vals (..., k) f32 desc-sorted, idx (..., k) i32).

    A stable descending sort keeps equal values in id order, so ties go
    to the smallest id, as ``lax.top_k`` breaks them.

    Signed zeros: -0 and +0 compare equal here, so they tie and go in id
    order, as in the reference's op (its Pallas tile kernel, and the
    port's CUDA kernel, which keys -0 as +0): logits [-0, +0, -0, +0, -1]
    at k = 4 give ids [0, 1, 2, 3].  ``lax.top_k`` alone orders on a
    total-order key that puts +0 above -0 and gives [1, 3, 0, 2]; the
    reference's op never hands it the raw logits.  The values returned
    are the selected elements' own, sign bit included ([-0, +0, -0, +0]
    above), as the CUDA kernel returns them.  The reference's op returns
    whichever zero its max reduction yields (four +0 above, but [+0, -0]
    for [+0, -0]): equal as numbers, the sign of a zero value is a
    deliberate difference.
    """
    vals, idx = torch.sort(logits.float(), dim=-1, descending=True,
                           stable=True)
    return (vals[..., :k].contiguous(),
            idx[..., :k].to(torch.int32).contiguous())


def tile_width(v: int, v_tile: int = 2048) -> int:
    """Vocab tile width for a row of ``v`` logits: the reference's
    choice (``ops.py``), a power of two in [128, v_tile]."""
    return max(min(v_tile, 1 << (v - 1).bit_length()), 128)


def topk_logits_tiles_ref(x: torch.Tensor, k: int, v_tile: int):
    """x (R, V) -> per-tile candidates (vals (R, nV*k) f32, idx i32).

    The row is padded with NEG to nV = ceil(V / v_tile) whole tiles; each
    tile gives its k largest values in descending order, ties to the
    smallest id.  Rounds of (max, first argmax, overwrite with NEG), as
    the reference's tile kernel does them, so a tile with fewer than k
    values above NEG repeats the first NEG column as it does.
    """
    r, v = x.shape
    n_tiles = -(-v // v_tile)
    xp = torch.full((r, n_tiles * v_tile), NEG, dtype=torch.float32,
                    device=x.device)
    xp[:, :v] = x.float()
    xt = xp.reshape(r, n_tiles, v_tile)
    col = torch.arange(v_tile, device=x.device)
    vals, idx = [], []
    for _ in range(k):
        m = xt.max(dim=-1).values                              # (R, nV)
        a = torch.where(xt == m[..., None], col,
                        torch.full_like(col, v_tile)).min(dim=-1).values
        vals.append(m)
        idx.append(a)
        xt = torch.where(col == a[..., None],
                         torch.full_like(xt, NEG), xt)
    base = torch.arange(n_tiles, device=x.device) * v_tile
    vals = torch.stack(vals, dim=-1).reshape(r, n_tiles * k)
    idx = (torch.stack(idx, dim=-1) + base[:, None]).reshape(r, n_tiles * k)
    return vals, idx.to(torch.int32)
