"""Train and serve steps shared by the trainer, the server and the
launchers.

``make_loss_fn`` loss kinds:
  "ce"           -- hard-label CE (the baseline supervised recipe, §2)
  "distill_topk" -- the paper's SSL objective: CE against the
                    reconstructed top-k teacher logits (§3.2.2).
Neither materializes the full (frames x vocab) logits: ``distill_topk``
runs the ``sparse_ce`` kernel on the card (the streamed chunk loop on
the host), ``ce`` the streamed chunk loop on both.  Only the LSTM AM
family's losses are ported; other families raise.

``make_prefill_step`` is the token LM's forward over a prompt (the
full-sequence attention runs the ``swa_attention`` kernel on the card);
``make_serve_step`` is one token-LM decode step (next-token selection
greedy, sampled, or mixed) for ``serve.TokenServer``.
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
    state dict the model runs with (``functional_call``), or None for
    the model's own weights."""
    if cfg.family == "lstm_am":
        args = (batch["feats"],)
    elif cfg.encoder is not None:
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder forward (whisper) is not "
            "ported yet (ROADMAP Queue 1, step 10b)")
    else:
        args = (_tensor(batch["tokens"], model.device),)
    if params is None:
        return model(*args)
    return functional_call(model, params, args)


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
            "AM's losses are (training the token LM is ROADMAP Queue 1, "
            "step 10d)")
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


def make_prefill_step(model, cfg):
    """Forward over the prompt; emit the last position's logits.

    -> ``prefill_step(batch)`` -> (B, 1, V) f32 for ``batch["tokens"]``
    (B, S).  The model owns its weights (the reference passes ``params``
    to the step), and the step runs under ``torch.inference_mode()``:
    the ``swa_attention`` kernel computes a forward only."""
    @torch.inference_mode()
    def prefill_step(batch):
        h, _ = model_forward(model, cfg, None, batch)
        return model.unembed(h[:, -1:])
    return prefill_step


def make_serve_step(model, cfg, *, greedy: bool = True,
                    use_kernel: bool = False, wide_fallback: bool = False):
    """One decode step: next token + logits + the updated cache.

    -> ``serve_step(cache, tokens)`` -> (next (B,1) int32, logits
    (B,1,V), cache); ``greedy=False`` returns a step taking an extra
    ``samp`` dict of (B,)-shaped per-row tensors (``temperature`` /
    ``top_k`` / ``top_p`` / ``seed``); rows with temperature <= 0 still
    take bitwise argmax.  The sampling key is derived from the
    *pre-step* cache position, so a request samples identically
    whatever the batch composition.  The model owns its weights (the
    reference passes ``params`` to the step).

    ``use_kernel=True`` routes next-token selection through the fused
    ``kernels.topk_sample`` op (one top-k extraction + Gumbel-max over a
    k_cap candidate set: the Hopper kernels on the card, their plain
    versions on the host) instead of a full-vocab argsort.  Greedy
    tokens stay bitwise equal to argmax; sampled tokens follow the fused
    sampler's truncated-nucleus semantics (kernels/topk_sample/ref.py).

    ``wide_fallback=True`` (fused sampling only) builds the *mixed*
    step: rows whose ``top_k`` the k_cap candidate set can't honor
    (``top_k <= 0`` — full vocab — or ``top_k > k_cap``) take the
    full-vocab argsort sampler, bitwise what the non-kernel server draws;
    every other row keeps the fused path.
    """
    if cfg.family == "lstm_am":
        raise ValueError("serve steps decode a token LM; the acoustic "
                         "model serves through serve.StreamServer")
    if use_kernel:
        from repro_torch.kernels.topk_sample import K_CAP_DEFAULT, topk_sample
    if not use_kernel or wide_fallback:
        from repro_torch.serve.sampling import sample_tokens

    if greedy:
        def serve_step(cache, tokens):
            logits, cache = model.decode_step(cache, tokens)
            if use_kernel:
                _, _, nxt = topk_sample(logits[:, -1], greedy=True)
            else:
                nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            return nxt[:, None], logits, cache
        return serve_step

    def serve_step_sample(cache, tokens, samp):
        pos = cache["pos"]
        logits, cache = model.decode_step(cache, tokens)
        last = logits[:, -1]
        args = (samp["temperature"], samp["top_k"], samp["top_p"],
                samp["seed"], pos)
        if use_kernel:
            _, _, nxt = topk_sample(last, *args)
            if wide_fallback:
                wide = (samp["top_k"] <= 0) | (samp["top_k"] > K_CAP_DEFAULT)
                nxt = torch.where(wide, sample_tokens(last, *args), nxt)
        else:
            nxt = sample_tokens(last, *args)
        return nxt[:, None], logits, cache
    return serve_step_sample
