"""Plain PyTorch version of single-token decode attention.

The same math as the non-fused decode path in
``models/attention.py:attention_decode`` and as the reference's
``kernels/decode_attention/ref.py``: the same RoPE rotation
(``layers.apply_rope``), the same per-row ring write
(``attention.row_update``), the same slot-validity mask
(``attention.decode_slot_validity``), the same einsum/cast order.  The
CPU paths and the tests use it; ``chip_smoke.py`` holds the kernel
against it on the card.

Like the kernel, it writes the new token into the caches it is given,
in place, and returns them.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import layers
from repro_torch.models.attention import (NEG_INF, decode_slot_validity,
                                          row_update)


def decode_attention_ref(q, k_new, v_new, cache_k, cache_v, pos, *,
                         window: int = 0, softcap: float = 0.0,
                         rope_theta: float = 0.0, write: bool = True,
                         rope_tables=None):
    """One-token decode tail.  q (B,Hq,1,hd) and k_new/v_new (B,Hkv,1,hd)
    are post-projection, pre-RoPE; cache_k/cache_v (B,Hkv,S,hd); pos (B,)
    int32 per-row positions.

    ``rope_theta>0`` applies RoPE at ``pos`` to q and k_new; ``write``
    ring-writes k_new/v_new at ``pos % S`` (in place); ``window>0``
    selects the SWA-ring validity mask.  ``rope_tables``: the (cos, sin)
    of ``layers.rope_tables(pos, hd, rope_theta)``, each (B, hd/2), or
    None to compute them here.

    Returns (o (B,Hq,1,hd) f32, cache_k, cache_v).
    """
    b, hq, _, hd = q.shape
    hkv = cache_k.shape[1]
    slots = cache_k.shape[2]
    if rope_theta:
        if rope_tables is None:
            cos, sin = layers.rope_tables(pos[:, None, None], hd, rope_theta)
        else:
            cos, sin = (t[:, None, None] for t in rope_tables)
        q = layers.apply_rope(q, cos, sin)
        k_new = layers.apply_rope(k_new, cos, sin)
    if write:
        slot = torch.fmod(pos, slots)
        row_update(cache_k, k_new, slot)
        row_update(cache_v, v_new, slot)
    valid = decode_slot_validity(pos, slots, window=window)
    scale = 1.0 / np.sqrt(hd)
    qg = q.reshape(b, hkv, hq // hkv, 1, hd)
    s_ = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(),
                      cache_k.float()) * scale
    s_ = layers.softcap(s_, softcap)
    s_ = torch.where(valid[:, None, None, None, :], s_, NEG_INF)
    p = torch.softmax(s_, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, cache_v.float())
    return o.reshape(b, hq, 1, hd), cache_k, cache_v
