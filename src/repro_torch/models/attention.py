"""GQA attention: cached single-token decode.

Only the decode half of the reference's ``models/attention.py`` is
ported: projections, the per-row contiguous KV cache, the shared
slot-validity mask, the plain decode tail and its fused twin
(``kernels/decode_attention``).  Full-sequence attention (prefill and
training: ``flash_full_attention``, ``windowed_attention``,
``attention_apply``) and the paged cache raise ``NotImplementedError``.

Caches are written in place: a decode step stores the new token's k and
v into the caller's cache tensors (the reference returns updated
copies; the values are the same).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import layers

NEG_INF = -1e30

_PREFILL = ("is not ported yet: full-sequence attention (prefill and "
            "training of the token LM) is ROADMAP Queue 1, step 10b")
_PAGED = ("paged KV caches are not ported yet (models/paging.py, ROADMAP "
          "Queue 1, step 10b)")


def init_attention(cfg, spec, *, generator, device):
    """{wq, wk, wv, wo} ~ N(0, 1/fan_in), plus zero ``bq/bk/bv`` with
    ``qkv_bias`` and zero ``q_norm/k_norm`` with ``qk_norm``.
    ``generator=None`` only on the meta device (a shape template)."""
    d, hq, hkv, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                      cfg.resolved_head_dim)
    p = {"wq": layers.dense_init(d, hq * hd, generator=generator,
                                 device=device),
         "wk": layers.dense_init(d, hkv * hd, generator=generator,
                                 device=device),
         "wv": layers.dense_init(d, hkv * hd, generator=generator,
                                 device=device),
         "wo": layers.dense_init(hq * hd, d, generator=generator,
                                 device=device)}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((hq * hd,), device=device)
        p["bk"] = torch.zeros((hkv * hd,), device=device)
        p["bv"] = torch.zeros((hkv * hd,), device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), device=device)
        p["k_norm"] = torch.zeros((hd,), device=device)
    return p


def _project_qkv(params, cfg, x, positions, *, rope=True):
    """x (B,S,D) -> q (B,Hq,S,hd), k/v (B,Hkv,S,hd), rope applied.

    ``rope=False`` skips the rotation (the fused decode kernel applies
    it instead — see ``kernels/decode_attention``).
    """
    b, s, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = x @ params["wq"].to(x.dtype)
    k = x @ params["wk"].to(x.dtype)
    v = x @ params["wv"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    q = q.reshape(b, s, hq, hd).transpose(1, 2)
    k = k.reshape(b, s, hkv, hd).transpose(1, 2)
    v = v.reshape(b, s, hkv, hd).transpose(1, 2)
    if cfg.qk_norm:
        q = layers.rms_head_norm(params["q_norm"], q)
        k = layers.rms_head_norm(params["k_norm"], k)
    if cfg.pos_emb == "rope" and rope:
        cos, sin = layers.rope_tables(positions, hd, cfg.rope_theta)
        q = layers.apply_rope(q, cos, sin)
        k = layers.apply_rope(k, cos, sin)
    return q, k, v


def flash_full_attention(*args, **kwargs):
    raise NotImplementedError("flash_full_attention " + _PREFILL)


def windowed_attention(*args, **kwargs):
    raise NotImplementedError("windowed_attention " + _PREFILL)


def attention_apply(*args, **kwargs):
    raise NotImplementedError("attention_apply " + _PREFILL)


# ---------------------------------------------------------------- decode

def init_attn_cache(cfg, spec, batch, seq_len, dtype, paging=None, *,
                    device):
    """Contiguous per-row cache {k, v}: (B, Hkv, slots, hd) zeros, with
    slots = min(window, seq_len) for a sliding-window layer."""
    if paging is not None:
        raise NotImplementedError(_PAGED)
    hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    slots = min(spec.window, seq_len) if (spec.mixer == "swa"
                                          and spec.window) else seq_len
    return {"k": torch.zeros((batch, hkv, slots, hd), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, hkv, slots, hd), dtype=dtype,
                             device=device)}


def row_update(cache_arr, new, slot, *, axis=2):
    """Per-row cache write, in place: row b of ``cache_arr`` takes
    ``new[b]`` (its size-1 ``axis`` dropped) at its own slot index.
    ``axis`` is the slot axis of the full batched array (2 for a
    (B, heads, S, hd) KV cache, 1 for a (B, S, d) latent cache); slot
    (B,) int.  Returns ``cache_arr``.  The reference's one-hot select
    returns a copy holding the same values."""
    rows = torch.arange(slot.shape[0], device=slot.device)
    index = (rows,) + (slice(None),) * (axis - 1) + (slot.long(),)
    cache_arr[index] = new.squeeze(axis).to(cache_arr.dtype)
    return cache_arr


def decode_slot_validity(pos, slots, *, window: int = 0):
    """Validity mask over cache slots for single-token decode — the mask
    math shared by the plain decode path and the fused kernel's plain
    version (``kernels/decode_attention/ref.py``).

    ``pos``: 0-d or (B,) int position(s); ``slots``: cache slot count.
    ``window=0`` — linear layout: slot j holds position j, valid iff
    ``j <= pos``.  ``window>0`` — SWA ring: slot j holds the latest
    position ``p <= pos`` with ``p % slots == j``, valid iff that p is
    in ``(pos - window, pos]`` and ``>= 0``.  Returns bool, shaped
    (slots,) for a 0-d pos and (B, slots) for per-row pos.
    """
    idx = torch.arange(slots, device=pos.device)
    posb = pos[..., None] if pos.dim() else pos
    if window:
        # slot j holds position: the latest p <= pos, p % slots == j
        kpos = posb - torch.fmod(posb - idx, slots)    # C remainder
        kpos = torch.where(kpos > posb, kpos - slots, kpos)  # safety
        return (kpos >= 0) & (posb - kpos < window) & (kpos <= posb)
    return idx <= posb


def _window(cfg, spec, slots: int) -> int:
    return spec.window if (spec.mixer == "swa" and spec.window
                           and slots < 2**30) else 0


def attention_decode(params, cfg, spec, x, cache, pos, pages=None,
                     use_kernel=False):
    """One-token decode. x (B,1,D); pos int32: 0-d (all rows in
    lockstep) or (B,) per-row positions (continuous batching: each row
    writes and reads its cache at its own position; ring indexing,
    masking and RoPE become row-indexed).  The cache {k, v} is written
    in place and returned.

    ``use_kernel=True`` routes per-row decode through the fused
    ``kernels/decode_attention`` op (RoPE + ring write + mask +
    softmax·V in one pass: the Hopper kernel on a CUDA tensor, its plain
    version on a CPU tensor).  Lockstep decode keeps the plain path."""
    if pages is not None or cache["k"].dim() == 3:
        raise NotImplementedError(_PAGED)
    b = x.shape[0]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    per_row = pos.dim() == 1 and pos.shape[0] == b
    if use_kernel and per_row:
        return _attention_decode_fused(params, cfg, spec, x, cache, pos)
    q, k, v = _project_qkv(params, cfg, x,
                           pos[:, None, None] if per_row
                           else (pos[None] if pos.dim() == 0 else pos))
    slots = cache["k"].shape[2]
    slot = torch.fmod(pos, slots)
    if per_row:
        row_update(cache["k"], k, slot)
        row_update(cache["v"], v, slot)
    else:
        at = slot.reshape(1).long()
        cache["k"].index_copy_(2, at, k.to(cache["k"].dtype))
        cache["v"].index_copy_(2, at, v.to(cache["v"].dtype))
    ck, cv = cache["k"], cache["v"]
    valid = decode_slot_validity(pos, slots, window=_window(cfg, spec,
                                                            slots))
    scale = 1.0 / np.sqrt(hd)
    qg = q.reshape(b, hkv, hq // hkv, 1, hd)
    s_ = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), ck.float()) * scale
    s_ = layers.softcap(s_, cfg.attn_softcap)
    s_ = torch.where(valid[:, None, None, None, :] if per_row else valid,
                     s_, NEG_INF)
    p = torch.softmax(s_, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, cv.float())
    o = o.reshape(b, hq, 1, hd).transpose(1, 2).reshape(b, 1, hq * hd)
    o = o.to(x.dtype) @ params["wo"].to(x.dtype)
    return o, cache


def _attention_decode_fused(params, cfg, spec, x, cache, pos):
    """Per-row decode through ``kernels/decode_attention``: the
    projections stay plain matrix products; the memory-bound tail —
    RoPE rotation, ring write, slot-validity mask, softmax·V — is one
    fused op."""
    # kernels/decode_attention/ref.py imports this module for the shared
    # mask helper, so the edge stays lazy here
    from repro_torch.kernels.decode_attention import decode_attention
    b = x.shape[0]
    hq, hd = cfg.n_heads, cfg.resolved_head_dim
    theta = cfg.rope_theta if cfg.pos_emb == "rope" else 0.0
    q, k, v = _project_qkv(params, cfg, x, pos[:, None, None], rope=False)
    slots = cache["k"].shape[2]
    o, _, _ = decode_attention(q, k, v, cache["k"], cache["v"], pos,
                               window=_window(cfg, spec, slots),
                               softcap=cfg.attn_softcap, rope_theta=theta)
    o = o.transpose(1, 2).reshape(b, 1, hq * hd)
    o = o.to(x.dtype) @ params["wo"].to(x.dtype)
    return o, cache
