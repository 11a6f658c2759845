"""Plain PyTorch version of the fused top-k/top-p Gumbel sampler.

The reference's ``kernels/topk_sample/ref.py`` defines the op's
semantics and the kernel is held to it exactly (vals, idx and the
sampled token).  It differs from ``serve/sampling.sample_tokens`` in one
documented way: the nucleus (top-p) mass is measured inside the
top-``k_cap`` candidate set (a renormalized softmax over k_cap values)
rather than over the full vocabulary, so the sampler never sorts a
(B, V) row.

Determinism contract shared with the kernel:

  * a stable descending sort and the kernel's max-extraction both break
    value ties toward the lower vocab index, so vals/idx agree bitwise;
  * the exclusive cumulative mass is a (k_cap, k_cap) strict-upper-
    triangular float32 matmul, as in the reference (its products are by
    0 and 1, so it is the rank-order sum the kernel takes);
  * the Gumbel noise is passed in (made once in ops.py from (seed,
    pos)), never re-derived per backend.

temperature <= 0 is the greedy sentinel per row: the returned token is
the first-maximum argmax of the row, bitwise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.topk_logits.ref import topk_logits_ref

NEG_INF = -1e30


def topk_sample_ref(logits, temperature=None, top_k=None, top_p=None,
                    gumbel=None, *, k_cap: int = 32, greedy: bool = False):
    """logits (B, V) -> (vals (B,k_cap) f32 desc, idx (B,k_cap) i32,
    token (B,) i32).

    ``greedy=True`` skips the sampling math: the token is the rank-0
    index.  Otherwise temperature/top_k/top_p are (B,) per-row knobs and
    ``gumbel`` is (B, k_cap) f32 noise applied by candidate rank.
    """
    vals, idx = topk_logits_ref(logits, k_cap)
    if greedy:
        return vals, idx, idx[:, 0].contiguous()
    dev = logits.device
    safe_t = torch.where(temperature > 0, temperature,
                         torch.ones_like(temperature))
    svals = vals / safe_t.float()[:, None]
    e = torch.exp(svals - svals[:, :1])            # rank 0 is the row max
    probs = e / e.sum(dim=1, keepdim=True)
    rank = torch.arange(k_cap, device=dev)
    tri = (rank[:, None] < rank[None, :]).float()
    excl = probs @ tri                             # mass before rank j
    k_eff = torch.where(top_k > 0, torch.clamp(top_k, max=k_cap),
                        torch.full_like(top_k, k_cap))
    keep = rank[None, :] < k_eff[:, None]
    keep &= excl < top_p[:, None]
    keep |= rank[None, :] == 0                     # rank 0 always sampleable
    pick = torch.argmax(torch.where(keep, svals, NEG_INF) + gumbel, dim=1)
    sampled = idx.gather(1, pick[:, None])[:, 0]
    token = torch.where(temperature > 0, sampled, idx[:, 0])
    return vals, idx, token.to(torch.int32)
