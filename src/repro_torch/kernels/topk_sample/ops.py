"""Public wrapper: fused top-k extraction + Gumbel-max sampling.

``topk_sample`` replaces the decode engine's full-vocab argsort sampler
with two stages on the card: the ``topk_logits`` stage-1 kernel takes
each vocab tile's top k_cap (the reference's tile rule: a power of two
in [128, 2048], so 75 tiles and 2,400 candidates per row at
V = 151,936), then the ``topk_sample`` kernel merges them and samples
over (B, k_cap).  On a CPU tensor it is ``topk_sample_ref``, with the
same bitwise semantics (``kernels/_dispatch.py``).

The Gumbel noise is derived here, once, by the port's threefry twin of
``fold_in(PRNGKey(seed), pos)`` followed by ``gumbel(key, (k_cap,))`` —
the reference's bits — and handed to whichever backend runs, so sampled
tokens are identical across backends by construction.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels._dispatch import auto_use_kernel
from repro_torch.kernels.topk_logits.kernel import topk_logits_tiles
from repro_torch.kernels.topk_logits.ref import tile_width
from repro_torch.kernels.topk_sample.kernel import topk_sample_tiles
from repro_torch.kernels.topk_sample.ref import topk_sample_ref
from repro_torch.utils import threefry

# Candidate-set width: the sampler's whole post-extraction state is
# (B, K_CAP_DEFAULT).  Rows whose top_k exceeds it take the full-vocab
# sampler instead (the token server's mixed window).
K_CAP_DEFAULT = 32


def gumbel_rows(seeds: torch.Tensor, pos: torch.Tensor, k: int):
    """Per-row rank-indexed Gumbel noise: (B,) seeds x (B,) pos ->
    (B, k) f32, on the seeds' device.  A pure function of (seed, pos),
    independent of batch composition — the contract of
    serve/sampling."""
    return threefry.gumbel(seeds, pos, k)


def topk_sample(logits: torch.Tensor, temperature=None, top_k=None,
                top_p=None, seeds=None, pos=None, *,
                k_cap: int = K_CAP_DEFAULT, greedy: bool = False,
                use_kernel: Optional[bool] = None):
    """logits (B, V) -> (vals (B,k_cap) f32 desc, idx (B,k_cap) i32,
    token (B,) i32) in one fused pass.

    ``greedy=True``: the token is argmax(logits) bitwise; the per-row
    knobs and seeds/pos are ignored.  Otherwise temperature / top_k /
    top_p / seeds / pos are (B,) per-row tensors; temperature <= 0 is
    the per-row greedy sentinel.  Nucleus mass is measured within the
    top-k_cap candidate set (see ref.py).
    """
    b, v = logits.shape
    kc = min(k_cap, v)
    gumbel = None if greedy else gumbel_rows(seeds, pos, kc)
    if not auto_use_kernel(logits, use_kernel):
        if greedy:
            return topk_sample_ref(logits, k_cap=kc, greedy=True)
        return topk_sample_ref(logits, temperature, top_k, top_p, gumbel,
                               k_cap=kc)
    x = logits.float().contiguous()
    cand_v, cand_i = topk_logits_tiles(x, kc, tile_width(v))
    if greedy:
        return topk_sample_tiles(cand_v, cand_i, None, None, None, None,
                                 k_cap=kc, greedy=True)
    return topk_sample_tiles(
        cand_v, cand_i, temperature.float().contiguous(),
        top_k.to(torch.int32).contiguous(), top_p.float().contiguous(),
        gumbel.contiguous(), k_cap=kc)
