"""Public wrapper: tile, run the stage-1 kernel, merge the candidates."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels._dispatch import auto_use_kernel
from repro_torch.kernels.topk_logits.kernel import (fused_merge,
                                                    topk_logits_merge,
                                                    topk_logits_rows,
                                                    topk_logits_tiles)
from repro_torch.kernels.topk_logits.ref import tile_width, topk_logits_ref


def topk_logits(logits: torch.Tensor, k: int = 20, *, v_tile: int = 2048,
                use_kernel: Optional[bool] = None):
    """logits (..., V) -> (vals (..., k) f32, idx (..., k) i32), sorted desc.

    On a CUDA tensor, two stages as in the reference: each vocab tile's
    top-k (the tile padding reads as NEG inside the kernel), then the
    merge of the (R, nV*k) candidates with ties to the smallest id.
    Where a row's tiles fit one block (``kernel.fused_merge``: up to 8
    tiles, as the AM's V = 3183 in 2) both stages are one launch;
    wider rows take a stage-1 launch and a merge launch.  On a CPU
    tensor it is ``topk_logits_ref``.
    """
    if not auto_use_kernel(logits, use_kernel):
        return topk_logits_ref(logits, k)
    shape = logits.shape
    v = shape[-1]
    if not 1 <= k <= v:
        raise ValueError(f"need 1 <= k <= V, got k={k}, V={v}")
    x = logits.reshape(-1, v).float().contiguous()
    vt = tile_width(v, v_tile)
    if fused_merge(v, k, vt):
        vals, idx = topk_logits_rows(x, k, vt)
    else:
        vals, idx = topk_logits_merge(*topk_logits_tiles(x, min(k, vt), vt),
                                      k)
    return vals.reshape(*shape[:-1], k), idx.reshape(*shape[:-1], k)
