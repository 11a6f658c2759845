"""Public wrappers: the differentiable lse + gather and the distill loss.

``sparse_ce_lse_gather`` is a ``torch.autograd.Function``, the twin of
the reference's ``custom_vjp`` (``ops.py:88-107``).  Its forward is the
Hopper kernel on a CUDA tensor and the full-logit plain version on a CPU
tensor; it saves (h, w, idx, lse).  Its backward is the reference's
streamed chunk recompute (``_lse_gather_bwd``), which the reference runs
in XLA outside any Pallas kernel and which stays PyTorch here: for each
vocab chunk it rebuilds the capped logits, reconstitutes the exact
softmax from the saved lse, scatter-adds the gathered-logit cotangent at
the teacher ids (duplicates add), chains through the softcap
(d tanh(x/c)*c = 1 - (capped/c)^2) and accumulates dh and the dw chunk.
Peak memory stays O(T*chunk + D*V), never (T, V).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels._dispatch import auto_use_kernel
from repro_torch.kernels.sparse_ce.kernel import sparse_ce_tiles
from repro_torch.kernels.sparse_ce.ref import sparse_ce_lse_gather_ref


def lse_gather_bwd(h, w, idx, lse, g_lse, g_z, *, softcap: float,
                   chunk: int = 1024):
    """(dh, dw) of (lse, gathered) given their cotangents, one vocab
    chunk at a time (the last chunk is narrower: no padded copy)."""
    t, d = h.shape
    v = w.shape[1]
    dh = torch.zeros((t, d), dtype=torch.float32, device=h.device)
    dw = torch.empty((d, v), dtype=torch.float32, device=h.device)
    rows = torch.arange(t, device=h.device)[:, None].expand_as(idx)
    ids = idx.long()
    hf = h.float()
    for c0 in range(0, v, chunk):
        wc = w[:, c0:c0 + chunk].float()
        width = wc.shape[1]
        raw = hf @ wc
        capped = torch.tanh(raw / softcap) * softcap if softcap else raw
        dz = g_lse[:, None] * torch.exp(capped - lse[:, None])
        loc = ids - c0
        inside = (loc >= 0) & (loc < width)
        dz.index_put_((rows, loc.clamp(0, width - 1)),
                      torch.where(inside, g_z, torch.zeros_like(g_z)),
                      accumulate=True)
        if softcap:
            dz = dz * (1.0 - (capped / softcap) ** 2)
        dh += dz @ wc.T
        dw[:, c0:c0 + width] = hf.T @ dz
    return dh.to(h.dtype), dw.to(w.dtype)


class _LseGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, idx, softcap: float, use_kernel: bool):
        if use_kernel:
            lse, z = sparse_ce_tiles(h, w, idx, softcap)
        else:
            lse, z = sparse_ce_lse_gather_ref(h, w, idx, softcap=softcap)
        ctx.save_for_backward(h, w, idx, lse)
        ctx.softcap = softcap
        return lse, z

    @staticmethod
    def backward(ctx, g_lse, g_z):
        h, w, idx, lse = ctx.saved_tensors
        dh, dw = lse_gather_bwd(h, w, idx, lse, g_lse, g_z,
                                softcap=ctx.softcap)
        return dh, dw, None, None, None


def sparse_ce_lse_gather(h: torch.Tensor, w: torch.Tensor,
                         idx: torch.Tensor, *, softcap: float = 0.0,
                         use_kernel: Optional[bool] = None):
    """h (T,D) f32, w (D,V) f32, idx (T,K) i32 -> (lse (T,), gathered
    (T,K)) f32, differentiable wrt h and w.

    Raises on any other dtype and on non-contiguous inputs, on either
    device.  Ids must lie in [0, V).
    """
    for name, t, dt in (("h", h, torch.float32), ("w", w, torch.float32),
                        ("idx", idx, torch.int32)):
        if t.dtype != dt or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous 2-D {dt} "
                             f"tensor, got {t.dtype} {tuple(t.shape)}")
    uk = auto_use_kernel(h, use_kernel)
    return _LseGather.apply(h, w, idx, float(softcap), uk)


def topk_distill_ce(h, w, topk_vals, topk_idx, *, softcap: float = 0.0,
                    mask=None, use_kernel: Optional[bool] = None):
    """The paper's SSL loss on the fused primitive.  h (T,D) flat
    frames; ``mask`` (T,) optional frame-validity weights (masked mean,
    as ``core/distill.chunked_topk_distill_ce``)."""
    lse, z = sparse_ce_lse_gather(h, w, topk_idx, softcap=softcap,
                                  use_kernel=use_kernel)
    q = torch.softmax(topk_vals.float(), dim=-1)
    nll = torch.sum(q * (lse[:, None] - z), dim=-1)
    if mask is not None:
        mk = mask.reshape(-1).float()
        return torch.sum(nll * mk) / torch.clamp(mk.sum(), min=1.0)
    return torch.mean(nll)
