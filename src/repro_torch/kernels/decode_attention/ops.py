"""Public entry point for fused single-token decode attention.

``decode_attention`` is the op ``models/attention.attention_decode``
dispatches to when built with ``use_kernel``: one call replacing the
separate RoPE / ring-write / mask / softmax·V passes of the plain tail.
On a CUDA tensor it launches the Hopper kernel; on a CPU tensor it is
``decode_attention_ref`` (``kernels/_dispatch.py``).

Unlike the reference's TPU path, nothing is padded: the kernel reads any
even head dim and any grouped-query count up to its limit in place.  The
RoPE tables are ``layers.rope_tables(pos, hd, theta)`` (a numpy-float32
frequency table, then cos and sin in float32), as the reference's
wrapper computes them.  A caller that runs many layers at one ``pos``
(``Transformer.decode_step``) computes them once and passes them in as
``rope_tables``; otherwise they are computed here.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels._dispatch import auto_use_kernel
from repro_torch.kernels.decode_attention.kernel import decode_attention_tiles
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.models import layers


def decode_attention(q, k_new, v_new, cache_k, cache_v, pos, *,
                     window: int = 0, softcap: float = 0.0,
                     rope_theta: float = 0.0, write: bool = True,
                     rope_tables=None, use_kernel: Optional[bool] = None):
    """Fused decode-attention tail for one token per row.

    q (B,Hq,1,hd), k_new/v_new (B,Hkv,1,hd) post-projection pre-RoPE;
    cache_k/cache_v (B,Hkv,S,hd); pos (B,) int32.  ``rope_theta>0``
    rotates q/k_new at pos inside the op; ``write`` ring-writes the new
    token at ``pos % S`` into the given caches, in place;
    ``window>0`` selects the SWA-ring validity mask.  ``rope_tables``,
    when given with ``rope_theta>0``, is ``layers.rope_tables(pos, hd,
    rope_theta)``: (cos, sin), each (B, hd/2) f32.

    Returns (o (B,Hq,1,hd) f32, cache_k, cache_v): the caches are the
    tensors passed in (written when ``write``).
    """
    if not auto_use_kernel(q, use_kernel):
        return decode_attention_ref(
            q, k_new, v_new, cache_k, cache_v, pos, window=window,
            softcap=softcap, rope_theta=rope_theta, write=write,
            rope_tables=rope_tables)
    b, hq, _, hd = q.shape
    hkv = cache_k.shape[1]
    pos = pos.to(torch.int32).contiguous()
    cos = sin = None
    if rope_theta:
        cos, sin = rope_tables if rope_tables is not None \
            else layers.rope_tables(pos, hd, rope_theta)     # (B, hd/2)
    o = decode_attention_tiles(
        q.float().reshape(b, hkv, hq // hkv, hd).contiguous(),
        k_new.float().reshape(b, hkv, hd).contiguous(),
        v_new.float().reshape(b, hkv, hd).contiguous(),
        cache_k, cache_v, pos, cos, sin, window=window,
        scale=float(np.float32(1.0 / np.sqrt(hd))), softcap=softcap,
        write=write)
    return o.reshape(b, hq, 1, hd), cache_k, cache_v
