"""Public entry point for causal sliding-window attention over a whole
sequence (prefill and training).

``swa_attention`` is the op ``models/attention.attention_apply`` calls on
a CUDA tensor, for both of the reference's branches: the windowed one
(``window = spec.window``) and the causal one (``window = S``, with the
caller's ``positions`` when it has them).  On a CUDA tensor it launches
the Hopper kernel; on a CPU tensor it is ``swa_attention_ref`` with the
kv heads repeated G-fold, as the reference's wrapper repeats them
(``kernels/_dispatch.py``).

Unlike the reference's TPU path, nothing is padded or repeated on the
card: the kernel reads any S and any head dim up to its limit in place
with ``scale = float32(1/sqrt(hd))``, and each query head reads its kv
head by index.

Under autograd the op is ``_SwaAttention``, a ``torch.autograd.Function``
(the ``sparse_ce`` precedent): its forward is the kernel on a CUDA tensor
(the plain version on a CPU tensor), and its backward
(``swa_attention_bwd``) is a chunked PyTorch recompute of the gradient
that XLA's autodiff gives the reference's ``flash_full_attention`` /
``windowed_attention``.  The reference has no backward kernel either.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels._dispatch import auto_use_kernel
from repro_torch.kernels.swa_attention.kernel import swa_attention_tiles
from repro_torch.kernels.swa_attention.ref import NEG, swa_attention_ref

BWD_CHUNK = 128           # query rows a backward step: its scores are
                          # (B, Hq, BWD_CHUNK, band), never (S, S) a head


def _scale(hd: int) -> float:
    return float(np.float32(1.0 / np.sqrt(hd)))


def _forward(q, k, v, positions, window: int, softcap: float,
             use_kernel: bool):
    """o (B,Hq,S,hd) f32: the kernel, or the plain version over kv
    repeated G-fold."""
    if use_kernel:
        return swa_attention_tiles(
            q.contiguous(), k.contiguous(), v.contiguous(), window=window,
            scale=_scale(q.shape[-1]), softcap=softcap,
            positions=None if positions is None
            else positions.to(torch.int32).contiguous())
    g = q.shape[1] // k.shape[1]
    if g > 1:
        k = k.repeat_interleave(g, dim=1)
        v = v.repeat_interleave(g, dim=1)
    return swa_attention_ref(q, k, v, window, softcap=softcap,
                             positions=positions)


def swa_attention_bwd(q, k, v, o, do, window: int, *, softcap: float = 0.0,
                      positions=None, chunk: int = BWD_CHUNK):
    """(dq, dk, dv) of ``swa_attention`` given o and its cotangent ``do``
    (both (B,Hq,S,hd)), recomputed ``chunk`` query rows at a time over
    their band of keys: [q0 - window + 1, q0 + chunk) by index, every key
    with ``positions``.  For each chunk: the scores (scaled, softcapped,
    masked to -1e30), their softmax p over the band, dv += p^T do,
    ds = p (do v^T - rowsum(do o)) where visible (the masked scores are
    constants, as the reference's ``jnp.where`` makes them), times
    1 - tanh^2 under the softcap, dq = ds k * scale, dk += ds^T q *
    scale.  A row that sees no key spreads its cotangent evenly over the
    band's v, as its forward averaged them, and passes none to q or k.
    GQA: dk and dv sum over each kv head's G query heads.  Memory is
    O(B * Hq * chunk * band)."""
    b, hq, s, hd = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    scale = _scale(hd)
    qf = q.float().reshape(b, hkv, g, s, hd)
    kf, vf = k.float(), v.float()
    dof = do.float().reshape(b, hkv, g, s, hd)
    delta = (dof * o.float().reshape(b, hkv, g, s, hd)).sum(-1)
    dq = torch.empty_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    pos = None if positions is None else positions.to(q.device).long()
    for q0 in range(0, s, chunk):
        q1 = min(s, q0 + chunk)
        if pos is None:
            k0, k1 = max(0, q0 - window + 1), q1
            rows = torch.arange(q0, q1, device=q.device)[:, None]
            cols = torch.arange(k0, k1, device=q.device)[None, :]
            vis = (cols <= rows) & (rows - cols < window)
        else:
            k0, k1 = 0, s
            pi = pos[q0:q1, None]
            vis = (pi >= 0) & (pos[None, :] <= pi)
        qc, doc = qf[:, :, :, q0:q1], dof[:, :, :, q0:q1]
        kc, vc = kf[:, :, k0:k1], vf[:, :, k0:k1]
        x = torch.einsum("bhgqd,bhkd->bhgqk", qc, kc) * scale
        if softcap:
            t = torch.tanh(x / softcap)
            x = t * softcap
        p = torch.softmax(torch.where(vis, x, NEG), dim=-1)
        dv[:, :, k0:k1] += torch.einsum("bhgqk,bhgqd->bhkd", p, doc)
        dp = torch.einsum("bhgqd,bhkd->bhgqk", doc, vc)
        ds = torch.where(vis, p * (dp - delta[:, :, :, q0:q1, None]), 0.0)
        if softcap:
            ds = ds * (1.0 - t * t)
        dq[:, :, :, q0:q1] = torch.einsum("bhgqk,bhkd->bhgqd", ds, kc) * scale
        dk[:, :, k0:k1] += torch.einsum("bhgqk,bhgqd->bhkd", ds, qc) * scale
    return (dq.reshape(q.shape).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


class _SwaAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, positions, window: int, softcap: float,
                use_kernel: bool):
        o = _forward(q, k, v, positions, window, softcap, use_kernel)
        ctx.save_for_backward(q, k, v, o, positions)
        ctx.window, ctx.softcap = window, softcap
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, positions = ctx.saved_tensors
        dq, dk, dv = swa_attention_bwd(q, k, v, o, do, ctx.window,
                                       softcap=ctx.softcap,
                                       positions=positions)
        return dq, dk, dv, None, None, None, None


def swa_attention(q, k, v, window: int, *, softcap: float = 0.0,
                  positions: Optional[torch.Tensor] = None,
                  use_kernel: Optional[bool] = None):
    """q (B,Hq,S,hd); k/v (B,Hkv,S,hd), Hq % Hkv == 0.  Causal + window:
    key j is visible to query i iff ``i - window < j <= i`` (window >= 1;
    a window of at least S is plain causal attention).  ``positions``
    (S,) int, taken only where window >= S (the reference's causal
    branch; its windowed branch masks by index): key j is visible to
    query i iff ``pos[i] >= 0 and pos[j] <= pos[i]``; a row with a
    negative position sees no key and gets the mean of v over the S keys.

    Returns (B,Hq,S,hd) f32, differentiable in q, k and v.  On a CUDA
    tensor, views (such as the transposed heads ``_project_qkv`` returns)
    are copied to contiguous tensors first; inputs are f32 or bf16.
    """
    window = int(window)
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    s = q.shape[2]
    if positions is not None and (positions.dim() != 1
                                  or positions.shape[0] != s
                                  or positions.is_floating_point()):
        raise ValueError(f"positions: expected an (S,) = ({s},) integer "
                         f"tensor, got {positions.dtype} "
                         f"{tuple(positions.shape)}")
    if positions is not None and window < s:
        raise ValueError(f"positions mask the causal branch only (window >= "
                         f"S); got window {window} < S {s}")
    uk = auto_use_kernel(q, use_kernel)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _SwaAttention.apply(q, k, v, positions, window,
                                   float(softcap), uk)
    return _forward(q, k, v, positions, window, float(softcap), uk)
