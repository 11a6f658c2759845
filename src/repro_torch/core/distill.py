"""Student/teacher losses (paper §3.2) with vocab-chunked streaming math.

The paper's objective: CE between the teacher's senone posterior and the
student's posterior, with the teacher distribution reconstructed from the
stored top-k logits (missing entries = large negative => renormalized
top-k softmax).

No chunked loss here materializes the full (frames x vocab) logit
matrix: logsumexp and the label/top-k gathers stream over vocab chunks
of the unembedding matrix.  ``chunked_topk_distill_ce`` runs that inner
loop through ``kernels/sparse_ce`` on a CUDA tensor (the Hopper kernel,
differentiable through its autograd function) and as the streamed chunk
loop below on a CPU tensor -- the loop is the reference's default, which
XLA runs.  ``chunked_ce`` is the streamed loop on both devices, as in
the reference, where it never reaches the Pallas kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels._dispatch import auto_use_kernel

NEG_FILL = -1e9          # paper: "filling the missing logits with large
                         # negative values"


# ------------------------------------------------------------- full-logit
# reference implementations (small vocab / tests)

def soft_ce(student_logits, teacher_logits, temperature: float = 1.0):
    """CE(teacher || student), mean over frames."""
    t = torch.log_softmax(teacher_logits / temperature, dim=-1)
    s = torch.log_softmax(student_logits / temperature, dim=-1)
    return -torch.mean(torch.sum(torch.exp(t) * s, dim=-1))


def topk_soft_ce(student_logits, topk_vals, topk_idx):
    """CE against the reconstructed top-k teacher distribution."""
    v = student_logits.shape[-1]
    k = topk_idx.shape[-1]
    canvas = torch.full((topk_idx.numel() // k, v), NEG_FILL,
                        dtype=torch.float32, device=student_logits.device)
    canvas.scatter_(-1, topk_idx.reshape(-1, k).long(),
                    topk_vals.reshape(-1, k).float())
    return soft_ce(student_logits, canvas.reshape(student_logits.shape))


# ------------------------------------------------------------ chunked CE

def _chunked_logsumexp_and_gather(h, w_unembed, gather_idx, *, chunk: int,
                                  softcap: float = 0.0):
    """Stream over vocab chunks of w_unembed (D, V).

    h: (T, D) hidden states; gather_idx: (T, K) vocab ids to gather logits
    for.  Returns (logsumexp (T,), gathered (T, K)) in float32 without
    ever materializing (T, V).  The last chunk is narrower (no padded
    copy of w).
    """
    t = h.shape[0]
    v = w_unembed.shape[1]
    k = gather_idx.shape[-1]
    ids = gather_idx.long()
    m = torch.full((t,), float("-inf"), dtype=torch.float32, device=h.device)
    l = torch.zeros((t,), dtype=torch.float32, device=h.device)
    g = torch.full((t, k), NEG_FILL, dtype=torch.float32, device=h.device)
    for c0 in range(0, v, chunk):
        wc = w_unembed[:, c0:c0 + chunk]
        width = wc.shape[1]
        logits = (h @ wc.to(h.dtype)).float()
        if softcap:
            logits = torch.tanh(logits / softcap) * softcap
        m_new = torch.maximum(m, logits.max(dim=-1).values)
        l = l * torch.exp(m - m_new) + torch.exp(
            logits - m_new[:, None]).sum(-1)
        loc = ids - c0
        inside = (loc >= 0) & (loc < width)
        picked = torch.gather(logits, -1, loc.clamp(0, width - 1))
        g = torch.where(inside, picked, g)
        m = m_new
    return m + torch.log(torch.clamp(l, min=1e-30)), g


def _masked_mean(nll, mask):
    if mask is None:
        return torch.mean(nll)
    mk = mask.reshape(-1).float()
    return torch.sum(nll * mk) / torch.clamp(mk.sum(), min=1.0)


def chunked_ce(h, w_unembed, labels, *, chunk: int = 8192,
               softcap: float = 0.0, mask=None):
    """Hard-label CE from hidden states, vocab-chunked. h (B,S,D)."""
    b, s, d = h.shape
    lse, gathered = _chunked_logsumexp_and_gather(
        h.reshape(b * s, d), w_unembed, labels.reshape(b * s, 1),
        chunk=chunk, softcap=softcap)
    return _masked_mean(lse - gathered[:, 0], mask)


def chunked_topk_distill_ce(h, w_unembed, topk_vals, topk_idx, *,
                            chunk: int = 8192, softcap: float = 0.0,
                            mask=None, use_kernel: Optional[bool] = None):
    """Paper §3.2.2 loss: CE between the renormalized top-k teacher
    distribution and the student's full-vocab distribution.

    teacher q_i = softmax over the k stored logits (missing = NEG_FILL,
    i.e. effectively zero mass).  loss = sum_i q_i (lse_student - z_i).

    ``use_kernel=None`` follows the device: ``kernels.sparse_ce`` on a
    CUDA tensor, the streamed chunk loop on a CPU tensor.
    """
    b, s, d = h.shape
    k = topk_idx.shape[-1]
    hf = h.reshape(b * s, d)
    idx = topk_idx.reshape(b * s, k)
    vals = topk_vals.reshape(b * s, k).float()
    if auto_use_kernel(hf, use_kernel):
        from repro_torch.kernels.sparse_ce import topk_distill_ce
        return topk_distill_ce(
            hf.contiguous(), w_unembed.contiguous(), vals,
            idx.to(torch.int32).contiguous(), softcap=softcap,
            mask=None if mask is None else mask.reshape(b * s),
            use_kernel=True)
    lse, z = _chunked_logsumexp_and_gather(hf, w_unembed, idx, chunk=chunk,
                                           softcap=softcap)
    q = torch.softmax(vals, dim=-1)                 # teacher top-k mass
    return _masked_mean(torch.sum(q * (lse[:, None] - z), dim=-1), mask)

