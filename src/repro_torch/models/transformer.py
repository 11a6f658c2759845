"""Decoder LM assembled from a ModelConfig's segments.

The twin of the reference's ``models/transformer.py`` for dense
attention blocks (``attn``/``swa`` mixers with an ``mlp`` channel mixer):
random init, embedding, the tied or separate unembedding, the
full-sequence forward ``apply`` (prefill; a segment is a Python loop over
its layers where the reference scans), the per-row decode cache and
``decode_step``, and the continuous batcher's row reset.  Other mixers
(RG-LRU, mLSTM, sLSTM, MLA), MoE, multi-token prediction and
encoder-decoder models raise ``NotImplementedError``.

Weights are the module's own parameters, named after the reference's
param tree with ``.`` for ``/``, except that a segment's stacked leaves
(leading axis ``repeat``) are one parameter per layer:
``seg{si}/p{i}/mixer/wq`` of shape (repeat, D, Hq*hd) is
``seg{si}.{g}.p{i}.mixer.wq`` of shape (D, Hq*hd) for g < repeat
(``checkpoint/convert.py`` unstacks them).  The reference's
``embed(params, tokens)`` is ``embed_tokens(tokens)`` here: ``embed``
names the table, as in the reference's tree.

The decode cache keeps the reference's stacked layout:
``cache["seg0"]["p0"]["k"]`` is (repeat, B, Hkv, S, hd) in the cache
dtype and ``cache["pos"]`` is (B,) int32 (per row) or a 0-d int32.  A
layer reads and writes the contiguous view ``[g]`` in place, and a row
reset is one op per stacked tensor.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.models import attention as attn_mod
from repro_torch.models import layers

_STEP = "ROADMAP Queue 1, step 10b"


def _check_supported(cfg):
    why = None
    if cfg.encoder is not None:
        why = "encoder-decoder models (whisper)"
    elif cfg.mla is not None:
        why = "MLA attention"
    elif cfg.mtp_depth:
        why = "multi-token prediction"
    elif cfg.pos_emb == "learned":
        why = "learned position embeddings"
    else:
        for seg in cfg.segments:
            for sp in seg.pattern:
                if sp.mixer not in ("attn", "swa"):
                    why = f"the {sp.mixer} mixer"
                elif sp.ffn != "mlp":
                    why = f"the {sp.ffn} channel mixer"
    if why:
        raise NotImplementedError(f"{cfg.name}: {why} is not ported yet "
                                  f"({_STEP})")


def _params(tensors) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in tensors.items()})


def init_block(cfg, spec, *, generator, device) -> nn.ModuleDict:
    return nn.ModuleDict({
        "norm1": _params(layers.norm_init(cfg.d_model, cfg.norm,
                                          device=device)),
        "mixer": _params(attn_mod.init_attention(cfg, spec,
                                                 generator=generator,
                                                 device=device)),
        "norm2": _params(layers.norm_init(cfg.d_model, cfg.norm,
                                          device=device)),
        "ffn": _params(layers.mlp_init(cfg.d_model, cfg.d_ff, gated=True,
                                       generator=generator, device=device)),
    })


def block_apply(params, cfg, spec, x, positions=None):
    """Full-sequence block: x (B,S,D) -> (x, aux); aux is ``{}`` for the
    dense blocks ported (the reference's MoE blocks fill it).  ``positions``
    None means ``arange(S)``, the only kind ``attention_apply`` takes on a
    CUDA tensor."""
    h = layers.norm_apply(params["norm1"], x, cfg.norm)
    x = x + attn_mod.attention_apply(params["mixer"], cfg, spec, h,
                                     positions)
    x = x + layers.mlp_apply(params["ffn"],
                             layers.norm_apply(params["norm2"], x, cfg.norm),
                             cfg.act)
    return x, {}


def block_decode(params, cfg, spec, x, cache, pos, pages=None,
                 use_kernel=False, rope_tables=None):
    """One block for one token: x (B,1,D) -> (x, cache).  ``rope_tables``
    is the step's (cos, sin) for the fused attention tail, or None."""
    h = layers.norm_apply(params["norm1"], x, cfg.norm)
    y, cache = attn_mod.attention_decode(params["mixer"], cfg, spec, h,
                                         cache, pos, pages=pages,
                                         use_kernel=use_kernel,
                                         rope_tables=rope_tables)
    x = x + y
    x = x + layers.mlp_apply(params["ffn"],
                             layers.norm_apply(params["norm2"], x, cfg.norm),
                             cfg.act)
    return x, cache


class Transformer(nn.Module):
    """The LM as a module.  ``generator`` draws the random init (a
    ``torch.Generator``, on the CPU or on the card: the reference's
    ``init``); it may be None only on the ``meta`` device, where the
    module is a shape template for loading weights.

    ``decode_kernel`` routes per-row decode attention through
    ``kernels/decode_attention`` (the Hopper kernel on the card, its
    plain version on the host); lockstep (0-d position) decode keeps the
    plain path regardless."""

    def __init__(self, cfg, *, device, generator: Optional[torch.Generator],
                 decode_kernel: bool = False):
        super().__init__()
        _check_supported(cfg)
        device = torch.device(device)
        self.cfg = cfg
        self.decode_kernel = decode_kernel
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

        Positions are ``arange(S)``; an explicit ``positions`` raises (the
        kernel route's causal mask is by index)."""
        if positions is not None:
            raise NotImplementedError(
                "explicit positions in Transformer.apply are not ported yet "
                f"({_STEP}): the forward runs positions arange(S)")
        cfg = self.cfg
        x = self.embed_tokens(tokens) if embeds is None else embeds
        for si, seg in enumerate(cfg.segments):
            groups = getattr(self, f"seg{si}")
            for gi in range(seg.repeat):
                for i, sp in enumerate(seg.pattern):
                    x, _ = block_apply(groups[gi][f"p{i}"], cfg, sp, x)
        x = layers.norm_apply(self.final_norm, x, cfg.norm)
        return x, {}

    def forward(self, tokens: torch.Tensor, **kw):
        """``apply``, so that ``torch.func.functional_call`` reaches it."""
        return self.apply(tokens, **kw)

    # ---- decode ----
    def init_cache(self, batch: int, seq_len: int, dtype=torch.bfloat16, *,
                   per_row: bool = False):
        """Decode cache on the model's device.  ``per_row=True`` carries
        one position per batch row ((B,) int32) instead of a shared 0-d
        one, which makes ragged continuous batching legal."""
        cfg = self.cfg
        dev = self.device
        cache = {"pos": torch.zeros((batch,) if per_row else (),
                                    dtype=torch.int32, device=dev)}
        for si, seg in enumerate(cfg.segments):
            group = {}
            for i, sp in enumerate(seg.pattern):
                one = attn_mod.init_attn_cache(cfg, sp, batch, seq_len, dtype,
                                               device=dev)
                group[f"p{i}"] = {k: torch.zeros((seg.repeat,) + a.shape,
                                                 dtype=dtype, device=dev)
                                  for k, a in one.items()}
            cache[f"seg{si}"] = group
        return cache

    @torch.no_grad()
    def decode_step(self, cache, tokens: torch.Tensor):
        """tokens (B,1) -> (logits (B,1,V) f32, cache).  Every layer
        writes its new k/v into ``cache`` in place; ``cache["pos"]``
        becomes pos + 1.  With a per-row cache every positional lookup is
        row-indexed.  On the fused route (``decode_kernel`` with per-row
        positions) the RoPE tables at ``pos`` are computed once here and
        shared by every layer."""
        cfg = self.cfg
        pos = cache["pos"]
        x = self.embed_tokens(tokens)
        rope = None
        if self.decode_kernel and pos.dim() == 1 and cfg.pos_emb == "rope":
            rope = layers.rope_tables(pos, cfg.resolved_head_dim,
                                      cfg.rope_theta)
        for si, seg in enumerate(cfg.segments):
            groups = getattr(self, f"seg{si}")
            seg_cache = cache[f"seg{si}"]
            for gi in range(seg.repeat):
                for i, sp in enumerate(seg.pattern):
                    c = {k: a[gi] for k, a in seg_cache[f"p{i}"].items()}
                    x, _ = block_decode(groups[gi][f"p{i}"], cfg, sp, x, c,
                                        pos, use_kernel=self.decode_kernel,
                                        rope_tables=rope)
        x = layers.norm_apply(self.final_norm, x, cfg.norm)
        cache["pos"] = pos + 1
        return self.unembed(x), cache

    @torch.no_grad()
    def reset_cache_rows(self, cache, rows: torch.Tensor,
                         starts: Optional[torch.Tensor] = None):
        """Reset the cache rows selected by the (B,) bool mask ``rows``
        — the continuous batcher's slot admission hook (per-row caches
        only).  Zeroes every KV entry of those rows, in place, one op per
        stacked tensor, and sets their position to ``starts`` (default
        0).  Returns ``cache``."""
        rows = rows.to(self.device)
        pos = cache["pos"]
        pos0 = torch.zeros_like(pos) if starts is None \
            else starts.to(pos.device, pos.dtype)
        cache["pos"] = torch.where(rows, pos0, pos)
        for si in range(len(self.cfg.segments)):
            for group in cache[f"seg{si}"].values():
                for a in group.values():     # (repeat, B, ...)
                    a.masked_fill_(rows.reshape((1, -1) + (1,) * (a.dim()
                                                                  - 2)), 0)
        return cache
