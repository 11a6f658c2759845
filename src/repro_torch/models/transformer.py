"""Decoder LM assembled from a ModelConfig's segments.

The twin of the reference's ``models/transformer.py``.  Sequence
mixers dispatch on ``LayerSpec.mixer``: ``attn``/``swa`` (multi-head
latent attention, ``models/mla.py``, when ``cfg.mla`` is set) and the
recurrent ``rglru``/``mlstm``/``slstm`` (``models/recurrent.py``);
channel mixers on ``LayerSpec.ffn``: ``mlp``, ``moe``
(``models/moe.py``) or ``none``, a block with no ``norm2`` and no
``ffn`` (xLSTM's blocks carry their own up-projections).  Random init,
embedding, the tied or separate unembedding, the full-sequence forward
``apply`` (prefill; a segment is a Python loop over its layers where the
reference scans) with the reference's aux (``seg{si}/p{i}/moe_*``,
summed over a segment's layers), the per-row decode cache and
``decode_step``, the continuous batcher's row reset, and multi-token
prediction's hidden (``mtp_hidden``, ``cfg.mtp_depth``).  Learned
positions raise ``NotImplementedError``; encoder-decoder models are
``models/whisper.py``.

Weights are the module's own parameters, named after the reference's
param tree with ``.`` for ``/``, except that a segment's stacked leaves
(leading axis ``repeat``) are one parameter per layer:
``seg{si}/p{i}/mixer/wq`` of shape (repeat, D, Hq*hd) is
``seg{si}.{g}.p{i}.mixer.wq`` of shape (D, Hq*hd) for g < repeat, and
an MoE layer's ``seg{si}/p{i}/ffn/w_gate`` of shape (repeat, E, D, F)
is ``seg{si}.{g}.p{i}.ffn.w_gate`` of shape (E, D, F)
(``checkpoint/convert.py`` unstacks them).  The multi-token prediction
module is ``mtp.norm``, ``mtp.proj`` and ``mtp.block.0.*``, the
reference's ``mtp/norm``, ``mtp/proj`` and ``mtp/block/*`` (a stack of
one block).  The reference's
``embed(params, tokens)`` is ``embed_tokens(tokens)`` here: ``embed``
names the table, as in the reference's tree.

The decode cache keeps the reference's stacked layout:
``cache["seg0"]["p0"]["k"]`` is (repeat, B, Hkv, S, hd) in the cache
dtype and ``cache["pos"]`` is (B,) int32 (per row) or a 0-d int32.  A
layer reads and writes the contiguous view ``[g]`` in place, and a row
reset is one op per stacked tensor.  With ``paging`` (a
``models.paging.PagedCacheConfig``) a full-attention layer's k/v are
pools (repeat, pool_slots, Hkv, hd), the view ``[g]`` written in place
too, and the cache root carries the shared block table
(``cache["pages"]``); sliding-window rings keep their per-row layout.
An MLA layer's cache is ``{c_kv, k_rope}``: (repeat, B, S, rank) and
(repeat, B, S, rope), or pools (repeat, pool_slots, ·) with paging,
whatever the spec's window.
A recurrent layer's cache is its state (``models/recurrent.py``'s
``init_*_state``), stacked the same way, and a decode step writes the
new state into it in place.  Its leaves take the dtypes the reference's
server settles them to after one step, whatever the cache dtype: the
recurrent state (``h``, ``C``, ``n``, ``m``, ``c``) float32 and the conv
tail in the compute dtype (the embedding's, float32).
A decode step feeds (B, 1, D) to an MoE layer: every row is a routing
group of one token, so nothing drops.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch import nn

from repro_torch.models import attention as attn_mod
from repro_torch.models import layers
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import paging as paging_mod
from repro_torch.models import recurrent

_ATTENTION = ("attn", "swa")


class _Mixer(NamedTuple):
    """A recurrent mixer's functions in ``models/recurrent.py``."""
    init: Callable
    apply: Callable
    decode: Callable
    init_state: Callable


_RECURRENT = {
    "rglru": _Mixer(recurrent.init_rglru_block, recurrent.rglru_block_apply,
                    recurrent.rglru_block_decode, recurrent.init_rglru_state),
    "mlstm": _Mixer(recurrent.init_mlstm_block, recurrent.mlstm_block_apply,
                    recurrent.mlstm_block_decode, recurrent.init_mlstm_state),
    "slstm": _Mixer(recurrent.init_slstm_block, recurrent.slstm_block_apply,
                    recurrent.slstm_block_decode, recurrent.init_slstm_state),
}

_STEP = "ROADMAP Queue 1, step 10b"


def _check_supported(cfg):
    if cfg.encoder is not None:
        raise ValueError(f"{cfg.name} is an encoder-decoder model: "
                         "models/whisper.py builds it")
    why = None
    if cfg.pos_emb == "learned":
        why = "learned position embeddings"
    else:
        for seg in cfg.segments:
            for sp in seg.pattern:
                if sp.mixer not in _ATTENTION + tuple(_RECURRENT):
                    why = f"the {sp.mixer} mixer"
                elif sp.ffn not in ("mlp", "moe", "none"):
                    why = f"the {sp.ffn} channel mixer"
    if why:
        raise NotImplementedError(f"{cfg.name}: {why} is not ported yet "
                                  f"({_STEP})")


def _params(tensors) -> nn.ParameterDict:
    """A parameter per tensor; a nested dict (the MoE's ``shared`` MLP)
    becomes a nested ``ParameterDict``, read as ``params["shared"]``."""
    return nn.ParameterDict({k: _params(v) if isinstance(v, dict)
                             else nn.Parameter(v)
                             for k, v in tensors.items()})


def init_block(cfg, spec, *, generator, device) -> nn.ModuleDict:
    """norm1 and the mixer, then norm2 and the ffn unless ``spec.ffn``
    is ``none`` (no such parameters, as in the reference's tree)."""
    kw = dict(generator=generator, device=device)
    if spec.mixer in _RECURRENT:
        mixer = _RECURRENT[spec.mixer].init(cfg, **kw)
    elif cfg.mla is not None:
        mixer = mla_mod.init_mla(cfg, **kw)
    else:
        mixer = attn_mod.init_attention(cfg, spec, **kw)
    block = {"norm1": _params(layers.norm_init(cfg.d_model, cfg.norm,
                                               device=device)),
             "mixer": _params(mixer)}
    if spec.ffn != "none":
        ffn = moe_mod.init_moe(cfg, **kw) if spec.ffn == "moe" else \
            layers.mlp_init(cfg.d_model, cfg.d_ff, gated=True, **kw)
        block["norm2"] = _params(layers.norm_init(cfg.d_model, cfg.norm,
                                                  device=device))
        block["ffn"] = _params(ffn)
    return nn.ModuleDict(block)


def _channel_mix(params, cfg, spec, x):
    """The block's channel mixer on the pre-norm residual, added:
    (x, aux).  ``ffn == "none"`` passes x through."""
    if spec.ffn == "none":
        return x, {}
    h = layers.norm_apply(params["norm2"], x, cfg.norm)
    if spec.ffn == "moe":
        y, aux = moe_mod.moe_apply(params["ffn"], cfg, h)
        return x + y, aux
    return x + layers.mlp_apply(params["ffn"], h, cfg.act), {}


def block_apply(params, cfg, spec, x, positions=None):
    """Full-sequence block: x (B,S,D) -> (x, aux); aux is the MoE
    layer's (``moe_lb_loss``, ``moe_z_loss``, ``moe_drop_frac``), ``{}``
    otherwise.  ``positions`` None means ``arange(S)``, the only kind
    the attention takes on a CUDA tensor; a recurrent mixer reads none
    and starts from a zero state."""
    h = layers.norm_apply(params["norm1"], x, cfg.norm)
    if spec.mixer in _RECURRENT:
        y, _ = _RECURRENT[spec.mixer].apply(params["mixer"], cfg, h)
    elif cfg.mla is not None:
        y = mla_mod.mla_apply(params["mixer"], cfg, h, positions)
    else:
        y = attn_mod.attention_apply(params["mixer"], cfg, spec, h,
                                     positions)
    return _channel_mix(params, cfg, spec, x + y)


def block_decode(params, cfg, spec, x, cache, pos, pages=None,
                 use_kernel=False, rope_tables=None):
    """One block for one token: x (B,1,D) -> (x, cache).  ``rope_tables``
    is the step's (cos, sin) at the layer's RoPE dim, or None.  An MLA
    layer decodes in its absorbed plain form whatever ``use_kernel``
    says, as the reference's does; a recurrent layer takes one step of
    its recurrence and writes the new state into ``cache`` in place."""
    h = layers.norm_apply(params["norm1"], x, cfg.norm)
    if spec.mixer in _RECURRENT:
        y, new = _RECURRENT[spec.mixer].decode(params["mixer"], cfg, h,
                                               cache)
        for k, a in new.items():
            cache[k].copy_(a)
    elif cfg.mla is not None:
        y, cache = mla_mod.mla_decode(params["mixer"], cfg, h, cache, pos,
                                      pages=pages, rope_tables=rope_tables)
    else:
        y, cache = attn_mod.attention_decode(params["mixer"], cfg, spec, h,
                                             cache, pos, pages=pages,
                                             use_kernel=use_kernel,
                                             rope_tables=rope_tables)
    x, _ = _channel_mix(params, cfg, spec, x + y)
    return x, cache


class Transformer(nn.Module):
    """The LM as a module.  ``generator`` draws the random init (a
    ``torch.Generator``, on the CPU or on the card: the reference's
    ``init``); it may be None only on the ``meta`` device, where the
    module is a shape template for loading weights.

    ``decode_kernel`` routes per-row decode attention through
    ``kernels/decode_attention`` (the Hopper kernel on the card, its
    plain version on the host); lockstep (0-d position) decode and MLA
    keep the plain path regardless.  ``paging`` (a ``PagedCacheConfig``,
    or None for the contiguous cache) selects the decode cache's
    layout."""

    def __init__(self, cfg, *, device, generator: Optional[torch.Generator],
                 decode_kernel: bool = False, paging=None):
        super().__init__()
        _check_supported(cfg)
        device = torch.device(device)
        self.cfg = cfg
        self.decode_kernel = decode_kernel
        self.paging = paging
        # per-step RoPE tables: the fused route's contiguous layers,
        # every paged layer and every MLA layer read them, an MLA
        # layer's at its own RoPE dim
        self._shared_rope = cfg.pos_emb == "rope" and (
            decode_kernel or paging is not None or cfg.mla is not None)
        self._rope_dim = (cfg.mla.qk_rope_head_dim if cfg.mla is not None
                          else cfg.resolved_head_dim)
        self.embed = nn.Parameter(layers.embed_init(
            cfg.vocab_size, cfg.d_model, generator=generator, device=device))
        self.final_norm = _params(layers.norm_init(cfg.d_model, cfg.norm,
                                                   device=device))
        if not cfg.tie_embeddings:
            self.out = nn.Parameter(layers.dense_init(
                cfg.d_model, cfg.vocab_size, generator=generator,
                device=device))
        for si, seg in enumerate(cfg.segments):
            self.add_module(f"seg{si}", nn.ModuleList(
                nn.ModuleDict({f"p{i}": init_block(cfg, sp,
                                                   generator=generator,
                                                   device=device)
                               for i, sp in enumerate(seg.pattern)})
                for _ in range(seg.repeat)))
        if cfg.mtp_depth:
            self.mtp = _MTP(cfg, generator=generator, device=device)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ---- embedding / unembedding ----
    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        h = self.embed[tokens.long()]
        if self.cfg.emb_scale:
            h = h * torch.tensor(self.cfg.d_model ** 0.5, dtype=h.dtype)
        return h

    def unembed_matrix(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.out

    def unembed(self, h: torch.Tensor) -> torch.Tensor:
        logits = h @ self.unembed_matrix().to(h.dtype)
        return layers.softcap(logits.float(), self.cfg.logit_softcap)

    # ---- full-sequence forward ----
    def apply(self, tokens: torch.Tensor, *, embeds=None, positions=None):
        """tokens (B,S) int (or embeds (B,S,D)) -> (hidden (B,S,D), aux).

        ``aux`` holds each MoE pattern position's aux under
        ``seg{si}/p{i}/<name>``, summed over the segment's layers, as
        the reference's scan returns it (``{}`` without MoE).  Positions
        are ``arange(S)``; an explicit ``positions`` raises (the kernel
        route's causal mask is by index)."""
        if positions is not None:
            raise NotImplementedError(
                "explicit positions in Transformer.apply are not ported yet "
                f"({_STEP}): the forward runs positions arange(S)")
        cfg = self.cfg
        x = self.embed_tokens(tokens) if embeds is None else embeds
        aux_total = {}
        for si, seg in enumerate(cfg.segments):
            groups = getattr(self, f"seg{si}")
            for gi in range(seg.repeat):
                for i, sp in enumerate(seg.pattern):
                    x, aux = block_apply(groups[gi][f"p{i}"], cfg, sp, x)
                    for name, v in aux.items():
                        key = f"seg{si}/p{i}/{name}"
                        aux_total[key] = (v if key not in aux_total
                                          else aux_total[key] + v)
        x = layers.norm_apply(self.final_norm, x, cfg.norm)
        return x, aux_total

    def mtp_hidden(self, hidden: torch.Tensor, tokens_shifted: torch.Tensor,
                   positions=None):
        """Multi-token prediction's hidden (predicts token t+2): the
        final ``hidden`` (B,S,D), normalised, beside the embedding of
        ``tokens_shifted`` (B,S), projected back to D and run through
        the MTP block.  None without ``cfg.mtp_depth``.  ``positions``
        as ``block_apply`` takes them."""
        cfg = self.cfg
        if not cfg.mtp_depth:
            return None
        mtp = self.mtp
        h = layers.norm_apply(mtp.norm, hidden, cfg.norm)
        e = self.embed_tokens(tokens_shifted)
        x = torch.cat([h, e], dim=-1) @ mtp.proj.to(hidden.dtype)
        spec = cfg.segments[-1].pattern[-1]
        for block in mtp.block:
            x, _ = block_apply(block, cfg, spec, x, positions)
        return x

    def forward(self, tokens: torch.Tensor, **kw):
        """``apply``, so that ``torch.func.functional_call`` reaches it."""
        return self.apply(tokens, **kw)

    # ---- decode ----
    def init_cache(self, batch: int, seq_len: int, dtype=torch.bfloat16, *,
                   per_row: bool = False):
        """Decode cache on the model's device.  ``per_row=True`` carries
        one position per batch row ((B,) int32) instead of a shared 0-d
        one, which makes ragged continuous batching legal.

        With ``paging`` the full-attention caches are shared pools and
        the root carries the block table ``cache["pages"]`` (``tables``
        (B, max_blocks) and ``caps`` (B,), int32 zeros: every row on the
        trash page); swa rings and recurrent state keep their per-row
        layout.  Paged caches are per-row only.

        ``dtype`` is the attention caches'.  A recurrent layer's state
        is float32 and its conv tail in the compute dtype whatever
        ``dtype`` says: the dtypes the reference's server settles its
        cache to before the first step."""
        cfg = self.cfg
        dev = self.device
        if self.paging is not None and not per_row:
            raise ValueError("paged caches are per-row only "
                             "(init_cache(per_row=True))")
        cache = {"pos": torch.zeros((batch,) if per_row else (),
                                    dtype=torch.int32, device=dev)}
        if self.paging is not None:
            cache["pages"] = {
                "tables": torch.zeros((batch, self.paging.max_blocks),
                                      dtype=torch.int32, device=dev),
                "caps": torch.zeros((batch,), dtype=torch.int32,
                                    device=dev)}
        for si, seg in enumerate(cfg.segments):
            group = {}
            for i, sp in enumerate(seg.pattern):
                if sp.mixer in _RECURRENT:
                    one = _RECURRENT[sp.mixer].init_state(
                        cfg, batch, self.embed.dtype, device=dev)
                elif cfg.mla is not None:
                    one = mla_mod.init_mla_cache(cfg, batch, seq_len, dtype,
                                                 paging=self.paging,
                                                 device=dev)
                else:
                    one = attn_mod.init_attn_cache(cfg, sp, batch, seq_len,
                                                   dtype, paging=self.paging,
                                                   device=dev)
                group[f"p{i}"] = {k: torch.zeros((seg.repeat,) + a.shape,
                                                 dtype=a.dtype, device=dev)
                                  for k, a in one.items()}
            cache[f"seg{si}"] = group
        return cache

    @torch.no_grad()
    def decode_step(self, cache, tokens: torch.Tensor):
        """tokens (B,1) -> (logits (B,1,V) f32, cache).  Every layer
        writes its new k/v into ``cache`` in place; ``cache["pos"]``
        becomes pos + 1.  With a per-row cache every positional lookup is
        row-indexed.  With per-row positions on the fused route
        (``decode_kernel``), a paged cache or MLA, the RoPE tables at
        ``pos`` are computed once here (at ``qk_rope_head_dim`` for MLA)
        and shared by the layers, as are a paged
        cache's write and gather slots (``paging.step_slots``).  A paged
        cache's ``pages`` are read, not changed: the host owns the block
        table."""
        cfg = self.cfg
        pos = cache["pos"]
        x = self.embed_tokens(tokens)
        pages = None
        if "pages" in cache:
            pages = paging_mod.step_slots(paging_mod.PageRef(
                cache["pages"]["tables"], cache["pages"]["caps"],
                self.paging.page_size), pos)
        rope = None
        if pos.dim() == 1 and self._shared_rope:
            rope = layers.rope_tables(pos, self._rope_dim, cfg.rope_theta)
        for si, seg in enumerate(cfg.segments):
            groups = getattr(self, f"seg{si}")
            seg_cache = cache[f"seg{si}"]
            for gi in range(seg.repeat):
                for i, sp in enumerate(seg.pattern):
                    c = {k: a[gi] for k, a in seg_cache[f"p{i}"].items()}
                    x, _ = block_decode(groups[gi][f"p{i}"], cfg, sp, x, c,
                                        pos, pages=pages,
                                        use_kernel=self.decode_kernel,
                                        rope_tables=rope)
        x = layers.norm_apply(self.final_norm, x, cfg.norm)
        cache["pos"] = pos + 1
        return self.unembed(x), cache

    @torch.no_grad()
    def reset_cache_rows(self, cache, rows: torch.Tensor,
                         starts: Optional[torch.Tensor] = None):
        """Reset the cache rows selected by the (B,) bool mask ``rows``
        — the continuous batcher's slot admission hook (per-row caches
        only).  Zeroes every per-row KV entry and recurrent state of
        those rows, in place, one op per stacked tensor, and sets their
        position to ``starts`` (default 0; a prefix-cache hit starts a
        row past its shared pages).  Paged pools are left alone: a row's
        stale pages are unreachable once its table row changes, and what
        lies past its ``pos`` is masked.  Returns ``cache``."""
        rows = rows.to(self.device)
        pos = cache["pos"]
        pos0 = torch.zeros_like(pos) if starts is None \
            else starts.to(pos.device, pos.dtype)
        cache["pos"] = torch.where(rows, pos0, pos)
        for si, seg in enumerate(self.cfg.segments):
            for i, sp in enumerate(seg.pattern):
                if self._paged(sp):
                    continue
                for a in cache[f"seg{si}"][f"p{i}"].values():  # (rep, B, ..)
                    a.masked_fill_(rows.reshape((1, -1) + (1,) * (a.dim()
                                                                  - 2)), 0)
        return cache

    def _paged(self, spec) -> bool:
        """Does this layer's decode cache live in a pool?  An attention
        layer's may (an MLA layer's does whatever its window); a
        recurrent layer's state never does."""
        return self.paging is not None and spec.mixer in _ATTENTION and (
            self.cfg.mla is not None or paging_mod.is_paged_spec(spec))


class _MTP(nn.Module):
    """The multi-token prediction module: ``norm``, ``proj`` (2D, D) and
    ``block``, one block of the last segment's last spec (the
    reference's ``mtp``, whose ``block`` is a stack of one)."""

    def __init__(self, cfg, *, generator, device):
        super().__init__()
        self.norm = _params(layers.norm_init(cfg.d_model, cfg.norm,
                                             device=device))
        self.proj = nn.Parameter(layers.dense_init(
            2 * cfg.d_model, cfg.d_model, generator=generator,
            device=device))
        self.block = nn.ModuleList([init_block(
            cfg, cfg.segments[-1].pattern[-1], generator=generator,
            device=device)])
