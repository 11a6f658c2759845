"""Plain PyTorch version of causal sliding-window attention, with the
full (S, S) mask: the twin of the reference's
``kernels/swa_attention/ref.py``.  The tests use it, and
``chip_smoke.py`` holds the kernel against it on the card; no model path
calls it (on the host, ``models/attention.py`` runs the chunked twins of
the reference's XLA path instead).
"""
from __future__ import annotations

import numpy as np
import torch

NEG = -1e30


def swa_attention_ref(q, k, v, window: int, *, softcap: float = 0.0):
    """q (B,H,S,hd); k/v (B,H,S,hd) (GQA pre-broadcast upstream).

    Causal + window: key j visible to query i iff  i - window < j <= i.
    Returns (B,H,S,hd) f32.
    """
    b, h, s, hd = q.shape
    scale = 1.0 / np.sqrt(hd)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    i = torch.arange(s, device=q.device)[:, None]
    j = torch.arange(s, device=q.device)[None, :]
    mask = (j <= i) & (i - j < window)
    logits = torch.where(mask[None, None], logits, NEG)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float())
