"""Model factory and the streaming-surface predicates.

``build_model(cfg, device=, generator=|params=)`` -> an ``nn.Module``
with the reference's uniform surface: the LSTM acoustic model
(``apply`` / ``unembed``, and for frame-synchronous models
``init_stream_state`` / ``stream_step`` / ``reset_stream_rows``) and the
dense decoder LM (``init_cache`` / ``decode_step`` / ``unembed`` /
``reset_cache_rows``).
"""
from __future__ import annotations

import functools
from typing import Mapping, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels._dispatch import resolve_device
from repro_torch.models.lstm_am import LstmAM, is_bidirectional
from repro_torch.models.transformer import Transformer


def build_model(cfg: ModelConfig, *, device=None,
                generator: Optional[torch.Generator] = None,
                params: Optional[Mapping[str, torch.Tensor]] = None,
                paging=None, decode_kernel: bool = False):
    """The model on ``device`` (default ``cuda``; raises without CUDA),
    with weights either drawn from ``generator`` or loaded from
    ``params`` (a state dict: ``model.state_dict()`` or
    ``checkpoint.convert.params_from_numpy``; tensors already on
    ``device`` in float32 are used as they are, not copied).

    ``decode_kernel=True`` routes the LM's per-row decode attention
    through ``kernels/decode_attention``.  ``paging`` (the paged KV
    cache) is not ported yet and raises."""
    if paging is not None:
        raise NotImplementedError("paged KV caches are not ported yet "
                                  "(ROADMAP Queue 1, step 10b)")
    if cfg.family == "lstm_am":
        if decode_kernel:
            raise ValueError("decode_kernel applies to KV-cache decode; "
                             "the LSTM acoustic model has none")
        make = LstmAM
    else:
        make = functools.partial(Transformer, decode_kernel=decode_kernel)
    dev = resolve_device(device)
    if params is None:
        if generator is None:
            raise ValueError("pass generator= for a random init or "
                             "params= to load weights")
        return make(cfg, device=dev, generator=generator)
    model = make(cfg, device="meta", generator=None)
    model.load_state_dict({k: v.to(dev, torch.float32)
                           for k, v in params.items()}, assign=True)
    return model


def supports_streaming(cfg: ModelConfig) -> bool:
    """True iff the model exposes the streaming surface: causal
    frame-synchronous AMs, and enc-dec (whisper) in the reference."""
    if cfg.family == "lstm_am":
        return not is_bidirectional(cfg)
    return cfg.encoder is not None


def stream_frame_sync(cfg: ModelConfig) -> bool:
    """True when ``stream_step`` emits one output position per input
    frame (the frame-synchronous AM)."""
    return cfg.family == "lstm_am"


def stream_feat_dim(cfg: ModelConfig) -> int:
    """Per-frame feature width a streaming chunk row carries."""
    return cfg.feat_dim if cfg.family == "lstm_am" else cfg.d_model
