"""Train steps shared by the trainer and the launchers.

``make_loss_fn`` loss kinds:
  "ce"           -- hard-label CE (the baseline supervised recipe, §2)
  "distill_topk" -- the paper's SSL objective: CE against the
                    reconstructed top-k teacher logits (§3.2.2).
Neither materializes the full (frames x vocab) logits: ``distill_topk``
runs the ``sparse_ce`` kernel on the card (the streamed chunk loop on
the host), ``ce`` the streamed chunk loop on both.  Only the LSTM AM
family is ported; other families raise.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.func import functional_call

from repro_torch.core import distill


def _tensor(a, device, dtype=None) -> torch.Tensor:
    """A host array or tensor -> a tensor on ``device``."""
    t = torch.as_tensor(a)
    return t.to(device=device, dtype=dtype or t.dtype, non_blocking=True)


def model_forward(model, cfg, params, batch):
    """Dispatch on input kind; returns (hidden, aux).  ``params`` is a
    state dict the model runs with (``functional_call``)."""
    if cfg.family != "lstm_am":
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}) is not ported yet: only the LSTM "
            "AM's losses are (ROADMAP Queue 1: token-LM side branch)")
    return functional_call(model, params, (batch["feats"],))


def make_loss_fn(model, cfg, loss_kind: str, *, vocab_chunk: int = 8192,
                 distill_kernel: Optional[bool] = None):
    """-> loss_fn(params, batch, rng=None) -> (loss, metrics).

    ``params`` is a state dict (tensors that may require grad); the
    batch's arrays move to the parameters' device here.
    ``distill_kernel=None`` follows the device: the ``sparse_ce`` kernel
    on a CUDA tensor, the streamed chunk loop on a CPU tensor.  The
    trailing ``rng`` is the Trainer's per-update generator; the AM's
    forward is deterministic, so it is unused.
    """
    if cfg.family != "lstm_am":
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}) is not ported yet: only the LSTM "
            "AM's losses are (ROADMAP Queue 1: token-LM side branch)")
    if loss_kind not in ("ce", "distill_topk"):
        raise ValueError(f"unknown loss kind {loss_kind!r}")

    def loss_fn(params, batch, rng=None):
        del rng
        w = model.unembed_matrix(params)
        dev = w.device
        h, _ = model_forward(model, cfg, params,
                             {"feats": _tensor(batch["feats"], dev,
                                               torch.float32)})
        cap = cfg.logit_softcap
        mask = batch.get("mask")
        mask = None if mask is None else _tensor(mask, dev)
        if loss_kind == "distill_topk":
            loss = distill.chunked_topk_distill_ce(
                h, w, _tensor(batch["topk_vals"], dev),
                _tensor(batch["topk_idx"], dev, torch.int32),
                chunk=vocab_chunk, softcap=cap, mask=mask,
                use_kernel=distill_kernel)
        else:
            loss = distill.chunked_ce(h, w, _tensor(batch["labels"], dev,
                                                    torch.int64),
                                      chunk=vocab_chunk, softcap=cap,
                                      mask=mask)
        return loss, {"loss": loss.detach(), "total_loss": loss.detach()}
    return loss_fn


def make_train_step(model, cfg, *, loss_kind: str = "ce",
                    optimizer: str = "momentum", clip: float = 1.0,
                    vocab_chunk: int = 8192,
                    distill_kernel: Optional[bool] = None):
    """-> train_step(params, opt_state, batch, lr, rng=None) ->
    (params, opt_state, metrics)."""
    from repro_torch.train.strategies import make_sgd_step
    loss_fn = make_loss_fn(model, cfg, loss_kind, vocab_chunk=vocab_chunk,
                           distill_kernel=distill_kernel)
    return make_sgd_step(loss_fn, optimizer=optimizer, clip=clip)
