"""GQA attention: full-sequence attention (prefill) and cached
single-token decode.

Full-sequence attention keeps the reference's two plain paths, as
PyTorch twins: ``flash_full_attention`` (two-level chunked online
softmax over q and kv positions) and ``windowed_attention`` (static band
slices, so cost scales as S * window).  They are the host's path and the
oracle of the tests.  On a CUDA tensor ``attention_apply`` computes
either branch with the ``kernels/swa_attention`` op instead (the Hopper
kernel the reference wrote for this function): ``window = spec.window``
where the reference takes the banded path, ``window = S`` where it takes
causal full attention.

Decode reads either cache layout: the contiguous per-row ``(B, Hkv, S,
hd)`` cache, or a paged pool ``(pool_slots, Hkv, hd)`` with the shared
block table (``models/paging.py``): the new token is written into the
pool, each row's logical context is gathered back to ``(B, Hkv,
max_ctx, hd)``, and the same masked-softmax tail runs over it — on the
fused route, ``decode_attention(write=False)`` over the gathered view.

Caches are written in place: a decode step stores the new token's k and
v into the caller's cache tensors (the reference returns updated
copies; the values are the same).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.swa_attention import swa_attention
from repro_torch.models import layers
from repro_torch.models import paging as paging_mod

NEG_INF = -1e30


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


def _group(q, hkv):
    """(B,Hq,S,hd) -> (B,Hkv,G,S,hd)."""
    b, hq, s, hd = q.shape
    return q.reshape(b, hkv, hq // hkv, s, hd)


def flash_full_attention(q, k, v, q_pos, kv_pos, *, causal=True,
                         attn_softcap=0.0, chunk_q=512, chunk_kv=1024,
                         bias_mask=None):
    """Two-level chunked flash attention.

    q (B,Hkv,G,Sq,hd); k (B,Hkv,Skv,hd); v (B,Hkv,Skv,hdv) (hdv may
    differ from hd); q_pos (Sq,), kv_pos (Skv,) int.  Returns
    (B,Hkv,G,Sq,hdv).  ``bias_mask`` is accepted and unused, as in the
    reference.
    """
    del bias_mask
    b, hkv, g, sq, hd = q.shape
    hdv = v.shape[-1]
    skv = k.shape[2]
    scale = 1.0 / np.sqrt(hd)
    cq = min(chunk_q, sq)
    ckv = min(chunk_kv, skv)
    # pad seq dims to chunk multiples
    pq = (-sq) % cq
    pkv = (-skv) % ckv
    qp = F.pad(q, (0, 0, 0, pq))
    kp = F.pad(k, (0, 0, 0, pkv))
    vp = F.pad(v, (0, 0, 0, pkv))
    qpos = F.pad(q_pos, (0, pq), value=-1)
    kpos = F.pad(kv_pos, (0, pkv), value=2**30)
    outs = []
    for q0 in range(0, sq + pq, cq):
        qc = qp[:, :, :, q0:q0 + cq].float()
        qpc = qpos[q0:q0 + cq]
        m = torch.full((b, hkv, g, cq), NEG_INF, device=q.device)
        l = torch.zeros((b, hkv, g, cq), device=q.device)
        a = torch.zeros((b, hkv, g, cq, hdv), device=q.device)
        for k0 in range(0, skv + pkv, ckv):
            kc = kp[:, :, k0:k0 + ckv].float()
            vc = vp[:, :, k0:k0 + ckv].float()
            kpc = kpos[k0:k0 + ckv]
            s_ = torch.einsum("bhgqd,bhkd->bhgqk", qc, kc) * scale
            s_ = layers.softcap(s_, attn_softcap)
            mask = qpc[:, None] >= 0
            if causal:
                mask = mask & (qpc[:, None] >= kpc[None, :])
            s_ = torch.where(mask, s_, NEG_INF)
            m_new = torch.maximum(m, s_.amax(dim=-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(s_ - m_new[..., None])
            l = l * corr + p.sum(dim=-1)
            a = a * corr[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", p,
                                                   vc)
            m = m_new
        outs.append(a / torch.clamp(l[..., None], min=1e-30))
    out = torch.cat(outs, dim=3)
    return out[..., :sq, :].to(q.dtype)


def windowed_attention(q, k, v, q_pos0, window, *, attn_softcap=0.0,
                       chunk_q=512):
    """Sliding-window causal attention; Sq == Skv (prefill/train).

    q (B,Hkv,G,S,hd); k/v (B,Hkv,S,hd).  For query chunk i only the
    [i*cq - window, i*cq + cq) key band is touched (a static slice), so
    FLOPs scale as S * (window + cq) instead of S^2.
    """
    b, hkv, g, s, hd = q.shape
    scale = 1.0 / np.sqrt(hd)
    cq = min(chunk_q, s)
    pq = (-s) % cq
    # pad keys left by `window` (masked) and right to a chunk multiple
    w = int(window)
    kp = F.pad(k, (0, 0, w, pq))
    vp = F.pad(v, (0, 0, w, pq))
    qp = F.pad(q, (0, 0, 0, pq))
    band = w + cq
    outs = []
    for q0 in range(0, s + pq, cq):
        qc = qp[:, :, :, q0:q0 + cq].float()
        kc = kp[:, :, q0:q0 + band].float()
        vc = vp[:, :, q0:q0 + band].float()
        qpos = q_pos0 + q0 + torch.arange(cq, device=q.device)
        kpos = q_pos0 + q0 - w + torch.arange(band, device=q.device)
        s_ = torch.einsum("bhgqd,bhkd->bhgqk", qc, kc) * scale
        s_ = layers.softcap(s_, attn_softcap)
        valid = (kpos[None, :] >= q_pos0) & (kpos[None, :] <= qpos[:, None]) \
            & (qpos[:, None] - kpos[None, :] < w)
        s_ = torch.where(valid, s_, NEG_INF)
        p = torch.softmax(s_, dim=-1)
        outs.append(torch.einsum("bhgqk,bhkd->bhgqd", p, vc))
    out = torch.cat(outs, dim=3)
    return out[..., :s, :].to(q.dtype)


def attention_apply(params, cfg, spec, x, positions=None):
    """Full-sequence (train/prefill) attention block body. x (B,S,D);
    positions (S,) int, or None for ``arange(S)``.

    On a CPU tensor: the reference's two plain paths, chunked as
    ``cfg.attn_whole_seq`` says.  On a CUDA tensor: the ``swa_attention``
    kernel for both (differentiable: its backward is a chunked PyTorch
    recompute).  Explicit positions move RoPE on both branches; they mask
    only the causal branch (``flash_full_attention``'s ``pos[j] <=
    pos[i]``, a negative position seeing no key), since the reference's
    windowed branch masks by index.  ``positions=None`` keeps the
    kernel's index mask, the same values as ``arange(S)``."""
    b, s, _ = x.shape
    explicit = positions
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q, k, v = _project_qkv(params, cfg, x, positions)
    windowed = spec.mixer == "swa" and spec.window and spec.window < s
    if x.device.type == "cuda":
        o = swa_attention(q, k, v, spec.window if windowed else s,
                          softcap=cfg.attn_softcap,
                          positions=None if windowed else explicit
                          ).to(x.dtype)
    else:
        qg = _group(q, cfg.n_kv_heads)
        # cost-probe mode: one whole-sequence chunk
        cq = s if cfg.attn_whole_seq else 512
        ckv = s if cfg.attn_whole_seq else 1024
        if windowed:
            o = windowed_attention(qg, k, v, 0, spec.window,
                                   attn_softcap=cfg.attn_softcap, chunk_q=cq)
        else:
            o = flash_full_attention(qg, k, v, positions, positions,
                                     attn_softcap=cfg.attn_softcap,
                                     chunk_q=cq, chunk_kv=ckv)
    o = o.reshape(b, cfg.n_heads, s, cfg.resolved_head_dim)
    o = o.transpose(1, 2).reshape(b, s, -1)
    return o @ params["wo"].to(x.dtype)


# ---------------------------------------------------------------- decode

def init_attn_cache(cfg, spec, batch, seq_len, dtype, paging=None, *,
                    device):
    """Cache {k, v} of zeros: with ``paging`` (a ``PagedCacheConfig``)
    and a pageable spec, a pool (pool_slots, Hkv, hd) with no batch axis
    — rows reach their pages through the shared block table; otherwise
    the contiguous per-row (B, Hkv, slots, hd), with slots = min(window,
    seq_len) for a sliding-window layer (its ring, paged or not)."""
    hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    if paging is not None and paging_mod.is_paged_spec(spec):
        slots = paging.pool_slots
        return {"k": torch.zeros((slots, hkv, hd), dtype=dtype,
                                 device=device),
                "v": torch.zeros((slots, hkv, hd), dtype=dtype,
                                 device=device)}
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
    returns a copy holding the same values.

    A row whose slot lies outside [0, slots) (a negative position's
    remainder) is left as it is, as the one-hot select matches no slot
    there: its clamped slot takes back its own value, so nothing waits
    on the card to pick the rows."""
    slots = cache_arr.shape[axis]
    slot = slot.long()
    rows = torch.arange(slot.shape[0], device=slot.device)
    inside = (slot >= 0) & (slot < slots)
    index = (rows,) + (slice(None),) * (axis - 1) \
        + (slot.clamp(0, slots - 1),)
    keep = inside.reshape((-1,) + (1,) * (cache_arr.dim() - 2))
    cache_arr[index] = torch.where(
        keep, new.squeeze(axis).to(cache_arr.dtype), cache_arr[index])
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
                     use_kernel=False, rope_tables=None):
    """One-token decode. x (B,1,D); pos int32: 0-d (all rows in
    lockstep) or (B,) per-row positions (continuous batching: each row
    writes and reads its cache at its own position; ring indexing,
    masking and RoPE become row-indexed).  The cache {k, v} is written
    in place and returned.

    A 3-D (pool) cache selects the paged path: ``pages`` (the step's
    ``paging.StepSlots``, from ``paging.step_slots`` of the block
    table's PageRef) and per-row positions are required; the new token
    goes into the pool at the row's write slot, and the tail reads the
    row's gathered logical context (masked columns give exact zeros in
    the softmax, so greedy tokens equal the contiguous path's).

    ``use_kernel=True`` routes per-row decode through the fused
    ``kernels/decode_attention`` op (RoPE + ring write + mask +
    softmax·V in one pass: the Hopper kernel on a CUDA tensor, its plain
    version on a CPU tensor).  Lockstep decode keeps the plain path.
    ``rope_tables``: the step's ``layers.rope_tables(pos, hd, theta)``,
    computed once for all layers by ``decode_step``; the fused op on a
    contiguous cache and a paged layer's projection read it (None:
    computed there)."""
    b = x.shape[0]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    per_row = pos.dim() == 1 and pos.shape[0] == b
    paged = cache["k"].dim() == 3
    if paged and (pages is None or not per_row):
        raise ValueError("paged attention cache requires per-row positions "
                         "and the step's slots (paging.step_slots of the "
                         "PageRef of cache['pages'])")
    if use_kernel and per_row:
        return _attention_decode_fused(params, cfg, spec, x, cache, pos,
                                       pages, rope_tables)
    if paged:
        q, k, v = _paged_qkv(params, cfg, x, pos, rope_tables)
        ck, cv = _paged_write_gather(cache, k, v, pages)
        valid = decode_slot_validity(pos, ck.shape[2])
    else:
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
        valid = decode_slot_validity(pos, slots,
                                     window=_window(cfg, spec, slots))
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


def _paged_qkv(params, cfg, x, pos, rope_tables):
    """q, k, v of a paged layer at per-row ``pos``, RoPE applied before
    the pool write: with the step's (B, hd/2) tables when given (the
    same values the projection computes), q and k rotated in one call
    over their concatenated heads (elementwise, so the same values)."""
    if rope_tables is None or cfg.pos_emb != "rope":
        return _project_qkv(params, cfg, x, pos[:, None, None])
    q, k, v = _project_qkv(params, cfg, x, None, rope=False)
    b, hq = q.shape[:2]
    cos, sin = (t.view(b, 1, 1, -1) for t in rope_tables)
    qk = layers.apply_rope(torch.cat([q, k], dim=1), cos, sin)
    return qk[:, :hq], qk[:, hq:], v


def _paged_write_gather(cache, k, v, pages):
    """Write the new token's k/v (B, Hkv, 1, hd) into the pools at each
    row's write slot (``pages``: the step's ``StepSlots``), in place,
    and return each row's gathered logical context (ck, cv), each (B,
    Hkv, max_ctx, hd) contiguous."""
    paging_mod.pool_write(cache["k"], k[:, :, 0], pages.write)
    paging_mod.pool_write(cache["v"], v[:, :, 0], pages.write)
    return (paging_mod.gather_pool(cache["k"], pages.gather),
            paging_mod.gather_pool(cache["v"], pages.gather))


def _attention_decode_fused(params, cfg, spec, x, cache, pos, pages=None,
                            rope_tables=None):
    """Per-row decode through ``kernels/decode_attention``: the
    projections stay plain matrix products; the memory-bound tail —
    RoPE rotation, ring write, slot-validity mask, softmax·V — is one
    fused op, given the step's RoPE tables when the caller has them.

    Paged: the pool write and the block-table gather stay plain
    indexing (the gather's indices are data), RoPE is applied before the
    pool write, as on the plain path, and the kernel runs the mask and
    softmax·V over the gathered view (``write=False``, no rotation, no
    window)."""
    # kernels/decode_attention/ref.py imports this module for the shared
    # mask helper, so the edge stays lazy here
    from repro_torch.kernels.decode_attention import decode_attention
    b = x.shape[0]
    hq, hd = cfg.n_heads, cfg.resolved_head_dim
    if cache["k"].dim() == 3:
        q, k, v = _paged_qkv(params, cfg, x, pos, rope_tables)
        ck, cv = _paged_write_gather(cache, k, v, pages)
        o, _, _ = decode_attention(q, k, v, ck, cv, pos,
                                   softcap=cfg.attn_softcap, write=False)
    else:
        theta = cfg.rope_theta if cfg.pos_emb == "rope" else 0.0
        q, k, v = _project_qkv(params, cfg, x, pos[:, None, None],
                               rope=False)
        slots = cache["k"].shape[2]
        o, _, _ = decode_attention(q, k, v, cache["k"], cache["v"], pos,
                                   window=_window(cfg, spec, slots),
                                   softcap=cfg.attn_softcap,
                                   rope_theta=theta,
                                   rope_tables=rope_tables)
    o = o.transpose(1, 2).reshape(b, 1, hq * hd)
    o = o.to(x.dtype) @ params["wo"].to(x.dtype)
    return o, cache
