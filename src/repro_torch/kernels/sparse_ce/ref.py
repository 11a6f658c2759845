"""Plain PyTorch versions of the fused logsumexp + top-k gather.

``sparse_ce_lse_gather_ref`` materializes the (T, V) logits once -- the
thing the kernel exists to avoid.  On a CPU tensor the autograd function
of ``ops.py`` runs it in place of the kernel; ``chip_smoke.py`` holds the
CUDA kernel against it on the card.
"""
from __future__ import annotations

import torch


def sparse_ce_lse_gather_ref(h: torch.Tensor, w: torch.Tensor,
                             idx: torch.Tensor, *, softcap: float = 0.0):
    """h (T,D), w (D,V), idx (T,K) -> (lse (T,), gathered (T,K)) f32."""
    logits = h.float() @ w.float()
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    lse = torch.logsumexp(logits, dim=-1)
    return lse, torch.gather(logits, -1, idx.long())


def topk_distill_ce_ref(h, w, topk_vals, topk_idx, *, softcap: float = 0.0):
    """The paper's SSL loss from the full-logit primitive."""
    lse, z = sparse_ce_lse_gather_ref(h, w, topk_idx, softcap=softcap)
    q = torch.softmax(topk_vals.float(), dim=-1)
    return torch.mean(torch.sum(q * (lse[:, None] - z), dim=-1))
