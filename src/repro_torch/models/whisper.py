"""Whisper-style encoder-decoder backbone.

The twin of the reference's ``models/whisper.py``.  The mel-spectrogram
and conv frontend is a stub there too: the encoder's input is
precomputed frame embeddings (B, S_enc, D).  Encoder: a bidirectional
self-attention stack.  Decoder: causal self-attention, cross-attention
to the encoder output and a non-gated MLP.  Learned position tables of
``MAX_POS`` rows (positions clipped to the last), as the reference's.

Weights are the module's own parameters, named after the reference's
param tree with ``.`` for ``/``; the reference's stacked ``enc_blocks``
and ``dec_blocks`` (a leading axis of layers) are one parameter per
layer: ``dec_blocks/cross/wq`` of shape (n, D, H*hd) is
``dec_blocks.{l}.cross.wq`` of shape (D, H*hd) (``checkpoint/convert.py``
unstacks them).  Caches and streaming state keep the reference's
stacked layout, layers on axis 0, and are written in place.

Three surfaces:
  * ``apply`` — the full-sequence forward (``encode`` then the decoder);
  * the token decode surface — ``init_cache`` / ``prefill_cache`` /
    ``decode_step`` / ``reset_cache_rows``;
  * the streaming surface (``serve.StreamServer``,
    ``StreamingEngine.feed``) — ``init_stream_state`` / ``stream_step``
    / ``reset_stream_rows`` / ``pull_stream_row`` / ``put_stream_row``:
    each chunk is encoded chunk-locally at the stream's frame offset, its
    cross-attention K/V go into the stream's row at that offset, and one
    incremental decoder step runs per chunk over the audio heard so far,
    feeding back its own greedy token.  Rows are independent: ragged
    chunks are masked by ``lens``, and a dead row (``lens == 0``) leaves
    its state as it was.

With ``paging`` (a ``models.paging.PagedCacheConfig``) the token
decode surface's self-attention k/v are pools (n, pool_slots, Hkv, hd)
addressed through the block table ``cache["pages"]``, as the reference's
are; the cross-attention K/V stay contiguous.  Whisper refuses
``decode_kernel`` (as the reference does), so its paged decode is the
plain path on the card too.  The streaming surface refuses paging.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import LayerSpec
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers
from repro_torch.models import paging as paging_mod
from repro_torch.models.transformer import _params, init_block

NEG_INF = -1e30
MAX_POS = 33_280
SPEC = LayerSpec(mixer="attn", ffn="mlp")


def _xattn_init(cfg, *, generator, device):
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim
    return {"wq": layers.dense_init(d, h * hd, generator=generator,
                                    device=device),
            "wk": layers.dense_init(d, h * hd, generator=generator,
                                    device=device),
            "wv": layers.dense_init(d, h * hd, generator=generator,
                                    device=device),
            "wo": layers.dense_init(h * hd, d, generator=generator,
                                    device=device)}


def _xattn_kv(params, cfg, enc):
    """Encoder output (B,S,D) -> cross-attention k, v (B,H,S,hd)."""
    b, s, _ = enc.shape
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    k = (enc @ params["wk"].to(enc.dtype)).reshape(b, s, h, hd)
    v = (enc @ params["wv"].to(enc.dtype)).reshape(b, s, h, hd)
    return k.transpose(1, 2), v.transpose(1, 2)


def _xattn_apply(params, cfg, x, ck, cv):
    """Cross attention: queries from x (B,Sq,D), K/V from the encoder."""
    b, sq, _ = x.shape
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    q = (x @ params["wq"].to(x.dtype)).reshape(b, sq, h, hd).transpose(1, 2)
    skv = ck.shape[2]
    o = attn_mod.flash_full_attention(
        q[:, :, None], ck, cv, torch.arange(sq, device=x.device),
        torch.arange(skv, device=x.device), causal=False,
        chunk_q=sq if cfg.attn_whole_seq else 512,
        chunk_kv=skv if cfg.attn_whole_seq else 1024)
    o = o[:, :, 0].transpose(1, 2).reshape(b, sq, h * hd)
    return o @ params["wo"].to(x.dtype)


def _init_dec_block(cfg, *, generator, device) -> nn.ModuleDict:
    def norm():
        return _params(layers.norm_init(cfg.d_model, cfg.norm, device=device))
    return nn.ModuleDict({
        "norm1": norm(),
        "self": _params(attn_mod.init_attention(cfg, SPEC, generator=generator,
                                                device=device)),
        "norm_x": norm(),
        "cross": _params(_xattn_init(cfg, generator=generator,
                                     device=device)),
        "norm2": norm(),
        "ffn": _params(layers.mlp_init(cfg.d_model, cfg.d_ff, gated=False,
                                       generator=generator, device=device)),
    })


def _mlp_tail(bp, cfg, x):
    return x + layers.mlp_apply(bp["ffn"],
                                layers.norm_apply(bp["norm2"], x, cfg.norm),
                                cfg.act)


class Whisper(nn.Module):
    """The encoder-decoder as a module.  ``generator`` draws the random
    init (a ``torch.Generator`` on the CPU or on the card); it may be
    None only on the ``meta`` device, where the module is a shape
    template for loading weights."""

    # stream-state batch axis per key: caches carry layers on axis 0
    _STREAM_ROW_AXIS = {"pos": 0, "enc_len": 0, "tok": 0,
                        "k": 1, "v": 1, "ck": 1, "cv": 1}

    def __init__(self, cfg, *, device, generator: Optional[torch.Generator],
                 paging=None):
        super().__init__()
        device = torch.device(device)
        self.cfg = cfg
        self.paging = paging        # PagedCacheConfig or None (contiguous)
        d = cfg.d_model
        self.enc_pos = nn.Parameter(layers.embed_init(
            MAX_POS, d, generator=generator, device=device))
        self.enc_blocks = nn.ModuleList(
            init_block(cfg, SPEC, generator=generator, device=device)
            for _ in range(cfg.encoder.n_layers))
        self.enc_norm = _params(layers.norm_init(d, cfg.norm, device=device))
        self.embed = nn.Parameter(layers.embed_init(
            cfg.vocab_size, d, generator=generator, device=device))
        self.dec_pos = nn.Parameter(layers.embed_init(
            MAX_POS, d, generator=generator, device=device))
        self.dec_blocks = nn.ModuleList(
            _init_dec_block(cfg, generator=generator, device=device)
            for _ in range(cfg.n_layers))
        self.final_norm = _params(layers.norm_init(d, cfg.norm,
                                                   device=device))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @staticmethod
    def _pos_embed(table, x, pos):
        """Rows of a learned position table at ``pos``, clipped: shaped
        pos.shape + (D,).  An index_select, so a 0-d ``pos`` is read on
        the device (indexing by a 0-d tensor reads it on the host, which
        a ``meta`` tensor cannot give)."""
        at = pos.clamp(0, MAX_POS - 1).long()
        return table.to(x.dtype).index_select(0, at.reshape(-1)).reshape(
            at.shape + table.shape[1:])

    # ---- encoder ----
    def _enc_block(self, bp, x, attend):
        cfg = self.cfg
        b, s, _ = x.shape
        h = layers.norm_apply(bp["norm1"], x, cfg.norm)
        q, k, v = attn_mod._project_qkv(bp["mixer"], cfg, h, None)
        o = attend(attn_mod._group(q, cfg.n_kv_heads), k, v)
        o = o.reshape(b, cfg.n_heads, s, cfg.resolved_head_dim)
        x = x + o.transpose(1, 2).reshape(b, s, -1) \
            @ bp["mixer"]["wo"].to(h.dtype)
        return _mlp_tail(bp, cfg, x)

    def encode(self, enc_embeds: torch.Tensor) -> torch.Tensor:
        """enc_embeds (B,S,D) from the stubbed conv frontend -> (B,S,D)."""
        cfg = self.cfg
        s = enc_embeds.shape[1]
        positions = torch.arange(s, device=enc_embeds.device)
        x = enc_embeds + self._pos_embed(self.enc_pos, enc_embeds, positions)

        def attend(qg, k, v):        # bidirectional: non-causal full
            return attn_mod.flash_full_attention(
                qg, k, v, positions, positions, causal=False,
                chunk_q=s if cfg.attn_whole_seq else 512,
                chunk_kv=s if cfg.attn_whole_seq else 1024)
        for bp in self.enc_blocks:
            x = self._enc_block(bp, x, attend)
        return layers.norm_apply(self.enc_norm, x, cfg.norm)

    # ---- decoder, full sequence ----
    def apply(self, tokens: torch.Tensor, *, enc_embeds: torch.Tensor,
              positions: Optional[torch.Tensor] = None):
        """tokens (B,St) -> (hidden (B,St,D), aux).  The decoder's causal
        self-attention is ``attention_apply``'s; ``positions`` (St,) int
        pick the learned position rows (clipped) and mask it, None being
        ``arange(St)``."""
        cfg = self.cfg
        enc = self.encode(enc_embeds)
        st = tokens.shape[1]
        pos = torch.arange(st, device=tokens.device) if positions is None \
            else positions
        x = self.embed[tokens.long()]
        x = x + self._pos_embed(self.dec_pos, x, pos)
        for bp in self.dec_blocks:
            h = layers.norm_apply(bp["norm1"], x, cfg.norm)
            x = x + attn_mod.attention_apply(bp["self"], cfg, SPEC, h,
                                             positions)
            hx = layers.norm_apply(bp["norm_x"], x, cfg.norm)
            ck, cv = _xattn_kv(bp["cross"], cfg, enc)
            x = x + _xattn_apply(bp["cross"], cfg, hx, ck, cv)
            x = _mlp_tail(bp, cfg, x)
        return layers.norm_apply(self.final_norm, x, cfg.norm), {}

    def forward(self, tokens: torch.Tensor, **kw):
        """``apply``, so that ``torch.func.functional_call`` reaches it."""
        return self.apply(tokens, **kw)

    def unembed_matrix(self, params=None) -> torch.Tensor:
        """The (D, V) unembedding, ``embed.T`` (tied): of a state dict
        ``params``, or the module's own."""
        return (self.embed if params is None else params["embed"]).T

    def unembed(self, h: torch.Tensor) -> torch.Tensor:
        return (h @ self.unembed_matrix().to(h.dtype)).float()

    # ---- token decode ----
    def init_cache(self, batch: int, seq_len: int, dtype=torch.bfloat16, *,
                   per_row: bool = False):
        """Decode cache on the model's device: self-attention k/v
        (n, B, Hkv, S, hd), cross-attention ck/cv (n, B, H, S, hd) for
        ``prefill_cache`` to fill, and ``pos`` ((B,) int32 with
        ``per_row``, else 0-d).  With ``paging`` the self-attention k/v
        are pools (n, pool_slots, Hkv, hd) and the root carries the block
        table ``pages`` (per-row caches only); ck/cv stay contiguous."""
        cfg = self.cfg
        n, h, hkv, hd = (cfg.n_layers, cfg.n_heads, cfg.n_kv_heads,
                         cfg.resolved_head_dim)
        dev = self.device

        def zeros(*shape):
            return torch.zeros(shape, dtype=dtype, device=dev)
        cache = {"pos": torch.zeros((batch,) if per_row else (),
                                    dtype=torch.int32, device=dev),
                 "ck": zeros(n, batch, h, seq_len, hd),
                 "cv": zeros(n, batch, h, seq_len, hd)}
        if self.paging is None:
            cache["k"] = zeros(n, batch, hkv, seq_len, hd)
            cache["v"] = zeros(n, batch, hkv, seq_len, hd)
            return cache
        if not per_row:
            raise ValueError("paged caches are per-row only "
                             "(init_cache(per_row=True))")
        cache["pages"] = {
            "tables": torch.zeros((batch, self.paging.max_blocks),
                                  dtype=torch.int32, device=dev),
            "caps": torch.zeros((batch,), dtype=torch.int32, device=dev)}
        cache["k"] = zeros(n, self.paging.pool_slots, hkv, hd)
        cache["v"] = zeros(n, self.paging.pool_slots, hkv, hd)
        return cache

    @torch.no_grad()
    def prefill_cache(self, enc_embeds: torch.Tensor, cache):
        """Run the encoder and write every layer's cross-attention K/V
        into the first S_enc slots of ``cache``, in place; returns it."""
        enc = self.encode(enc_embeds)
        s = enc.shape[1]
        for i, bp in enumerate(self.dec_blocks):
            ck, cv = _xattn_kv(bp["cross"], self.cfg, enc)
            cache["ck"][i, :, :, :s] = ck.to(cache["ck"].dtype)
            cache["cv"][i, :, :, :s] = cv.to(cache["cv"].dtype)
        return cache

    @torch.no_grad()
    def decode_step(self, cache, tokens: torch.Tensor):
        """tokens (B,1) -> (logits (B,1,V) f32, cache)."""
        x, cache = self._decode_hidden(cache, tokens)
        return self.unembed(x), cache

    def _decode_hidden(self, cache, tokens: torch.Tensor):
        """One cached decode step, returning the final-norm hidden
        (B,1,D); each layer writes its self-attention k/v into ``cache``
        in place, and ``cache["pos"]`` becomes pos + 1.  With
        ``enc_len`` in the cache (the streaming state) the unwritten tail
        of the cross-attention buffers is masked; without it (the token
        surface, whose ck/cv are filled by ``prefill_cache``) every slot
        is attended, as in the reference."""
        cfg = self.cfg
        b = tokens.shape[0]
        h_, hd = cfg.n_heads, cfg.resolved_head_dim
        pos = cache["pos"]
        x = self.embed[tokens.long()]
        pe = self._pos_embed(self.dec_pos, x, pos)
        x = x + (pe[:, None] if pos.dim() else pe[None, None])
        pages = None
        if "pages" in cache:
            pages = paging_mod.step_slots(paging_mod.PageRef(
                cache["pages"]["tables"], cache["pages"]["caps"],
                self.paging.page_size), pos)
        xbias = None
        if "enc_len" in cache:
            s_enc = cache["ck"].shape[3]
            xvalid = torch.arange(s_enc, device=x.device)[None, :] \
                < cache["enc_len"][:, None]
            xbias = torch.where(xvalid, 0.0, NEG_INF)[:, None, None, :]
        for i, bp in enumerate(self.dec_blocks):
            h = layers.norm_apply(bp["norm1"], x, cfg.norm)
            y, _ = attn_mod.attention_decode(
                bp["self"], cfg, SPEC, h,
                {"k": cache["k"][i], "v": cache["v"][i]}, pos, pages=pages)
            x = x + y
            hx = layers.norm_apply(bp["norm_x"], x, cfg.norm)
            # cross attention over the cached encoder K/V
            hq = (hx @ bp["cross"]["wq"].to(hx.dtype)).reshape(
                b, 1, h_, hd).transpose(1, 2)
            s_ = torch.einsum("bhqd,bhkd->bhqk", hq.float(),
                              cache["ck"][i].float()) / math.sqrt(hd)
            if xbias is not None:
                s_ = s_ + xbias
            p = torch.softmax(s_, dim=-1)
            o = torch.einsum("bhqk,bhkd->bhqd", p, cache["cv"][i].float())
            o = o.to(x.dtype).transpose(1, 2).reshape(b, 1, -1)
            x = x + o @ bp["cross"]["wo"].to(x.dtype)
            x = _mlp_tail(bp, cfg, x)
        cache["pos"] = pos + 1
        return layers.norm_apply(self.final_norm, x, cfg.norm), cache

    @torch.no_grad()
    def reset_cache_rows(self, cache, rows: torch.Tensor,
                         starts: Optional[torch.Tensor] = None):
        """Zero the self-attention k/v of the rows selected by the (B,)
        bool mask, in place, and set their positions to ``starts``
        (default 0).  Cross-attention K/V are kept: they belong to the
        encoder pass and ``prefill_cache`` refills them.  Paged pools are
        left alone (a row's stale pages are unreachable once its table
        row changes).  Returns ``cache``."""
        rows = rows.to(self.device)
        pos = cache["pos"]
        pos0 = torch.zeros_like(pos) if starts is None \
            else starts.to(pos.device, pos.dtype)
        cache["pos"] = torch.where(rows, pos0, pos)
        if self.paging is not None:
            return cache
        for key in ("k", "v"):
            cache[key].masked_fill_(rows.reshape(1, -1, 1, 1, 1), 0)
        return cache

    # ---- streaming ----
    def init_stream_state(self, batch: int, dtype=torch.float32, *,
                          max_frames: int = 256, max_tokens: int = 64):
        """Per-stream state: decoder self-attention rows (``max_tokens``,
        one decoder token a chunk), cross-attention K/V buffers
        (``max_frames`` audio frames; frames past it are dropped), the
        frames-written count ``enc_len`` (the cross-attention validity
        bound) and the fed-back token.  A paged model refuses it."""
        if self.paging is not None:
            raise ValueError("streaming whisper uses contiguous per-row "
                             "caches; build the model without paging")
        cfg = self.cfg
        n, h, hkv, hd = (cfg.n_layers, cfg.n_heads, cfg.n_kv_heads,
                         cfg.resolved_head_dim)
        dev = self.device

        def zeros(heads, slots):
            return torch.zeros((n, batch, heads, slots, hd), dtype=dtype,
                               device=dev)

        def ints(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=dev)
        return {"pos": ints(batch), "k": zeros(hkv, max_tokens),
                "v": zeros(hkv, max_tokens), "ck": zeros(h, max_frames),
                "cv": zeros(h, max_frames), "enc_len": ints(batch),
                "tok": ints(batch, 1)}

    @torch.no_grad()
    def stream_step(self, state, feats: torch.Tensor, *,
                    lens: Optional[torch.Tensor] = None):
        """One streaming chunk: feats (B,t,D) encoder embeddings ->
        (hidden (B,1,D), state).  One output position a chunk: the
        incremental decoder's next-token hidden.  ``state`` is updated in
        place and returned.

        The chunk's cross-attention K/V are added at the rows' frame
        offsets, as the reference's one-hot product adds them: the slots
        are zeros since the row's reset, padded frames (``t >= lens``)
        and frames past ``max_frames`` add nothing.  Dead rows (``lens ==
        0``) keep every buffer: they add no K/V, and the one self-
        attention slot the decoder step wrote is restored."""
        cfg = self.cfg
        b, t, _ = feats.shape
        dev = feats.device
        hd = cfg.resolved_head_dim
        if lens is None:
            lens = torch.full((b,), t, dtype=torch.int32, device=dev)
        lens = lens.to(dev, torch.int32)
        alive = lens > 0
        # ---- chunk-local encoder at per-row frame offsets
        steps = torch.arange(t, device=dev)
        pos_rows = state["enc_len"][:, None] + steps              # (B,t)
        x = feats + self._pos_embed(self.enc_pos, feats, pos_rows)
        valid = steps[None, :] < lens[:, None]                     # (B,t)
        bias = torch.where(valid, 0.0, NEG_INF)[:, None, None, None, :]

        def attend(qg, k, v):
            s_ = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(),
                              k.float()) / math.sqrt(hd)
            p = torch.softmax(s_ + bias, dim=-1)
            return torch.einsum("bhgqk,bhkd->bhgqd", p,
                                v.float()).to(feats.dtype)
        for bp in self.enc_blocks:
            x = self._enc_block(bp, x, attend)
        enc = layers.norm_apply(self.enc_norm, x, cfg.norm)
        # ---- the chunk's cross-attention K/V into the rows' buffers
        s_max = state["ck"].shape[3]
        write = (valid & (pos_rows < s_max))[:, :, None, None, None]
        rows = torch.arange(b, device=dev)[:, None].expand(b, t)
        slot = pos_rows.clamp(max=s_max - 1)
        kvs = [_xattn_kv(bp["cross"], cfg, enc) for bp in self.dec_blocks]
        for key, new in (("ck", [k for k, _ in kvs]),
                         ("cv", [v for _, v in kvs])):
            buf = state[key]
            # (n, B, H, t, hd) -> (B, t, n, H, hd), the order of the
            # buffer's (B, S, n, H, hd) view indexed by (rows, slot)
            new = torch.stack(new).permute(1, 3, 0, 2, 4).to(buf.dtype)
            buf.permute(1, 3, 0, 2, 4).index_put_(
                (rows, slot), torch.where(write, new, 0.0), accumulate=True)
        enc_len = state["enc_len"] + lens
        # ---- one incremental decoder step over the audio heard so far
        pos = state["pos"]
        at = (torch.arange(b, device=dev),
              torch.fmod(pos, state["k"].shape[3]).long())
        kept = [state[key].permute(1, 3, 0, 2, 4)[at].clone()
                for key in ("k", "v")]
        cache = {"pos": pos, "k": state["k"], "v": state["v"],
                 "ck": state["ck"], "cv": state["cv"], "enc_len": enc_len}
        hidden, _ = self._decode_hidden(cache, state["tok"])
        nxt = torch.argmax(self.unembed(hidden)[:, -1],
                           dim=-1).to(torch.int32)[:, None]
        # ---- dead rows do not advance
        dead = ~alive[:, None, None, None]
        for key, old in zip(("k", "v"), kept):
            view = state[key].permute(1, 3, 0, 2, 4)
            view[at] = torch.where(dead, old, view[at])
        state["pos"] = torch.where(alive, pos + 1, pos)
        state["enc_len"] = torch.where(alive, enc_len, state["enc_len"])
        state["tok"] = torch.where(alive[:, None], nxt, state["tok"])
        return hidden, state

    @torch.no_grad()
    def reset_stream_rows(self, state, rows: torch.Tensor):
        """Zero every buffer's rows selected by the (B,) bool mask, in
        place — slot admission for the streaming surface.  Returns
        ``state``."""
        rows = rows.to(self.device)
        for key, a in state.items():
            axis = self._STREAM_ROW_AXIS[key]
            shape = [1] * a.dim()
            shape[axis] = -1
            a.masked_fill_(rows.reshape(shape), 0)
        return state

    def pull_stream_row(self, state, i: int):
        """Stream ``i``'s slice of every state buffer, copied to the host
        (detach: the serving layer parks it).  Round-trips bitwise
        through ``put_stream_row``."""
        return {key: a.select(self._STREAM_ROW_AXIS[key], i)
                .to("cpu", copy=True) for key, a in state.items()}

    def put_stream_row(self, state, i: int, row):
        """Write a pulled row back into slot ``i``, in place; returns the
        state."""
        for key, a in state.items():
            a.select(self._STREAM_ROW_AXIS[key], i).copy_(row[key])
        return state
