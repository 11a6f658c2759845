"""Multi-head latent attention (DeepSeek-V3).

The twin of the reference's ``models/mla.py``.  Prefill decompresses
the latent ``c_kv`` into per-head k/v and runs full causal attention;
decode is the *absorbed* form: the cache holds only ``(c_kv, k_rope)``
a token, ``w_uk`` is folded into the query and ``w_uv`` applied after
the attention, so a step reads S * (kv_rank + rope_dim) a layer rather
than the decompressed S * H * (qk_dim + v_dim).

Full sequence (``mla_apply``): on a CPU tensor the plain
``attention.flash_full_attention``, which takes v's own head dim; on a
CUDA tensor the ``swa_attention`` kernel with window = S.  The kernel
takes one head dim for q, k and v, so v (``v_head_dim``) is zero-padded
to q's (``qk_nope_head_dim + qk_rope_head_dim``) and the output sliced
back: the padded columns add 0 * p to sums nobody reads, and the
wrapper's scale 1/sqrt(hd) is MLA's 1/sqrt(qk dim).  Every head is its
own kv head (G = 1).

Decode (``mla_decode``) is plain PyTorch, as the reference's is plain
XLA: einsums over the latent cache in three layouts, the lockstep
(0-d ``pos``) and per-row ((B,) ``pos``) contiguous caches ``(B, S,
rank)`` and the paged pools ``(pool_slots, rank)`` with no batch axis
(``models/paging.py``).  As in the reference, the new token is read
back from the cache after its cast to the cache dtype, ``q_c`` is
computed in x's dtype and the scores in float32, and ``o_c`` is cast to
x's dtype before ``w_uv``.  Caches are written in place (the reference
returns updated copies holding the same values).  MLA attends over the
whole sequence in every path: a ``+swa`` spec's window is ignored, as
in the reference.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.swa_attention import swa_attention
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers
from repro_torch.models import paging as paging_mod

NEG_INF = -1e30


def init_mla(cfg, *, generator, device):
    """The reference's parameters: ``w_dq`` (D, q_rank), ``q_norm``,
    ``w_uq`` (q_rank, H*qk_dim), ``w_dkv`` (D, kv_rank + rope),
    ``kv_norm``, ``w_uk`` (kv_rank, H*nope), ``w_uv`` (kv_rank, H*v) and
    ``wo`` (H*v, D), each ~ N(0, 1/fan_in); the norms' scales zero."""
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim

    def dense(fan_in, fan_out):
        return layers.dense_init(fan_in, fan_out, generator=generator,
                                 device=device)
    return {
        "w_dq": dense(d, m.q_lora_rank),
        "q_norm": layers.norm_init(m.q_lora_rank, "rmsnorm", device=device),
        "w_uq": dense(m.q_lora_rank, h * qk_dim),
        "w_dkv": dense(d, m.kv_lora_rank + m.qk_rope_head_dim),
        "kv_norm": layers.norm_init(m.kv_lora_rank, "rmsnorm",
                                    device=device),
        "w_uk": dense(m.kv_lora_rank, h * m.qk_nope_head_dim),
        "w_uv": dense(m.kv_lora_rank, h * m.v_head_dim),
        "wo": dense(h * m.v_head_dim, d),
    }


def _rope(positions, cfg, rope_tables):
    """(cos, sin) at ``qk_rope_head_dim``: ``rope_tables`` when the
    caller computed them for the step, else from ``positions``."""
    if rope_tables is not None:
        return rope_tables
    return layers.rope_tables(positions, cfg.mla.qk_rope_head_dim,
                              cfg.rope_theta)


def _queries(params, cfg, x, positions, rope_tables=None):
    """-> q_nope (B,H,S,nope), q_rope (B,H,S,rope) with RoPE applied.
    ``rope_tables``: (cos, sin) broadcastable to (B,H,S,rope/2)."""
    m = cfg.mla
    b, s, _ = x.shape
    cq = x @ params["w_dq"].to(x.dtype)
    cq = layers.norm_apply(params["q_norm"], cq, "rmsnorm")
    q = (cq @ params["w_uq"].to(x.dtype)).reshape(
        b, s, cfg.n_heads, m.qk_nope_head_dim + m.qk_rope_head_dim
    ).transpose(1, 2)
    q_nope = q[..., :m.qk_nope_head_dim]
    cos, sin = _rope(positions, cfg, rope_tables)
    q_rope = layers.apply_rope(q[..., m.qk_nope_head_dim:], cos, sin)
    return q_nope, q_rope


def _latents(params, cfg, x, positions, rope_tables=None):
    """-> c_kv (B,S,rank) normalised, k_rope (B,S,rope) with RoPE
    applied.  ``rope_tables``: (cos, sin) broadcastable to
    (B,S,rope/2)."""
    m = cfg.mla
    dkv = x @ params["w_dkv"].to(x.dtype)
    c_kv = layers.norm_apply(params["kv_norm"], dkv[..., :m.kv_lora_rank],
                             "rmsnorm")
    cos, sin = _rope(positions, cfg, rope_tables)
    k_rope = layers.apply_rope(dkv[..., m.kv_lora_rank:], cos, sin)
    return c_kv, k_rope


def mla_apply(params, cfg, x, positions=None):
    """Full-sequence MLA (the decompressed path): x (B,S,D) -> (B,S,D).
    ``positions`` (S,) int, or None for ``arange(S)``, the only kind the
    kernel route takes (its causal mask is by index)."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    if x.device.type == "cuda" and positions is not None:
        raise NotImplementedError(
            "explicit positions in mla_apply on a CUDA tensor are not "
            "ported yet (ROADMAP step 10b): the swa_attention kernel masks "
            "by index, so pass positions=None for arange(S)")
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q_nope, q_rope = _queries(params, cfg, x, positions)
    c_kv, k_rope = _latents(params, cfg, x, positions)
    k_nope = (c_kv @ params["w_uk"].to(x.dtype)).reshape(
        b, s, h, m.qk_nope_head_dim).transpose(1, 2)
    v = (c_kv @ params["w_uv"].to(x.dtype)).reshape(
        b, s, h, m.v_head_dim).transpose(1, 2)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, None].expand(b, h, s,
                                                  m.qk_rope_head_dim)],
                  dim=-1)
    if x.device.type == "cuda":
        # one head dim for q, k and v: v zero-padded, the output cut back
        pad = q.shape[-1] - m.v_head_dim
        o = swa_attention(q, k, F.pad(v, (0, pad)), s)[..., :m.v_head_dim]
        o = o.to(x.dtype)
    else:
        # MHA is GQA with one query head a group
        cq = s if cfg.attn_whole_seq else 512
        ckv = s if cfg.attn_whole_seq else 1024
        o = attn_mod.flash_full_attention(q[:, :, None], k, v, positions,
                                          positions, chunk_q=cq,
                                          chunk_kv=ckv)[:, :, 0]
    o = o.transpose(1, 2).reshape(b, s, h * m.v_head_dim)
    return o @ params["wo"].to(x.dtype)


def init_mla_cache(cfg, batch, seq_len, dtype, paging=None, *, device):
    """The latent cache {c_kv, k_rope} of zeros: with ``paging`` (a
    ``PagedCacheConfig``) pools (pool_slots, kv_rank) and (pool_slots,
    rope) with no batch axis; otherwise (B, seq_len, kv_rank) and (B,
    seq_len, rope).  A window is ignored: MLA keeps the whole sequence."""
    m = cfg.mla
    lead = (paging.pool_slots,) if paging is not None else (batch, seq_len)
    return {"c_kv": torch.zeros(lead + (m.kv_lora_rank,), dtype=dtype,
                                device=device),
            "k_rope": torch.zeros(lead + (m.qk_rope_head_dim,), dtype=dtype,
                                  device=device)}


def _write_read(cache, c_new, kr_new, pos, pages, per_row: bool):
    """Write the new token's latents (B,1,·) into ``cache`` in place and
    return what the step reads, (c (B,S,rank), kr (B,S,rope)), in the
    cache dtype: the pools' gathered rows, or the contiguous cache."""
    if pages is not None:
        for key, new in (("c_kv", c_new), ("k_rope", kr_new)):
            paging_mod.pool_write(cache[key], new[:, 0], pages.write)
        return (paging_mod.gather_pool(cache["c_kv"], pages.gather),
                paging_mod.gather_pool(cache["k_rope"], pages.gather))
    if per_row:
        attn_mod.row_update(cache["c_kv"], c_new, pos, axis=1)
        attn_mod.row_update(cache["k_rope"], kr_new, pos, axis=1)
    else:
        # the reference's dynamic_update_slice clamps its start
        at = pos.clamp(0, cache["c_kv"].shape[1] - 1).reshape(1).long()
        cache["c_kv"].index_copy_(1, at, c_new.to(cache["c_kv"].dtype))
        cache["k_rope"].index_copy_(1, at, kr_new.to(cache["k_rope"].dtype))
    return cache["c_kv"], cache["k_rope"]


def mla_decode(params, cfg, x, cache, pos, pages=None,
               rope_tables: Optional[tuple] = None):
    """Absorbed single-token decode.  x (B,1,D); ``pos`` 0-d (lockstep
    rows) or (B,) per-row positions.  A 2-D (pool) latent cache selects
    the paged path, which takes per-row positions and ``pages``, the
    step's ``paging.StepSlots``.  ``rope_tables``: the step's (cos, sin)
    at ``qk_rope_head_dim`` for per-row ``pos``, ((B, rope/2) each), or
    None to compute them here.  The cache is written in place; returns
    (y (B,1,D), cache)."""
    m = cfg.mla
    b = x.shape[0]
    h = cfg.n_heads
    scale = 1.0 / np.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    per_row = pos.dim() == 1 and pos.shape[0] == b
    paged = cache["c_kv"].dim() == 2
    if paged and (pages is None or not per_row):
        raise ValueError("paged MLA cache requires per-row positions and "
                         "the step's slots (paging.step_slots of the "
                         "PageRef of cache['pages'])")
    qt = kt = None
    if rope_tables is not None and per_row:
        cos, sin = rope_tables
        qt = (cos.view(b, 1, 1, -1), sin.view(b, 1, 1, -1))
        kt = (cos.view(b, 1, -1), sin.view(b, 1, -1))
    q_nope, q_rope = _queries(params, cfg, x,
                              pos[:, None, None] if per_row else pos[None],
                              qt)
    c_new, kr_new = _latents(params, cfg, x,
                             pos[:, None] if per_row else pos[None], kt)
    c, kr = _write_read(cache, c_new, kr_new, pos,
                        pages if paged else None, per_row)
    # absorb w_uk into the query: q_c (B,H,rank), in x's dtype
    w_uk = params["w_uk"].to(x.dtype).reshape(m.kv_lora_rank, h,
                                              m.qk_nope_head_dim)
    q_c = torch.einsum("bhd,rhd->bhr", q_nope[:, :, 0], w_uk)
    cf = c.float()
    s_ = (torch.einsum("bhr,bsr->bhs", q_c.float(), cf)
          + torch.einsum("bhd,bsd->bhs", q_rope[:, :, 0].float(),
                         kr.float())) * scale
    valid = attn_mod.decode_slot_validity(pos, c.shape[1])
    s_ = torch.where(valid[:, None] if per_row else valid, s_, NEG_INF)
    p = torch.softmax(s_, dim=-1)
    # attention over the latents, then decompress once a head
    o_c = torch.einsum("bhs,bsr->bhr", p, cf)
    w_uv = params["w_uv"].to(x.dtype).reshape(m.kv_lora_rank, h,
                                              m.v_head_dim)
    o = torch.einsum("bhr,rhv->bhv", o_c.to(x.dtype), w_uv)
    o = o.reshape(b, 1, h * m.v_head_dim)
    return o @ params["wo"].to(x.dtype), cache
