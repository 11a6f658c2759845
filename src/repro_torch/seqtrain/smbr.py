"""State-level minimum Bayes risk (paper §2/§3.4/§5.3).

loss = - E_{path ~ p(path | O)} [ frame accuracy vs. reference alignment ]
     = - (1/T) sum_t sum_s gamma_t(s) * 1[s == ref_t]

with gamma from forward-backward over the denominator graph using scaled
acoustic scores  kappa * (log softmax(logits) - log prior).  The twin of
the reference's ``seqtrain/smbr.py``: the gradient flows through the
whole alpha/beta recursion by autograd (``fb.py``'s scaled recursion,
O(T * B * S) saved), which is the textbook sMBR
"gamma * (acc - E[acc])" outer product.

The paper performs sMBR only on the labeled data (§3.4) with the GTC
trainer (§5.3); the optional CE interpolation (f-smoothing) is the
reference's, default off.  The losses return their metrics detached.
"""
from __future__ import annotations

import torch

from repro_torch.launch.steps import _tensor, model_forward
from repro_torch.seqtrain.fb import forward_backward


def _on(graph, device):
    """``graph`` with tensor arrays on ``device`` (converted if not)."""
    if isinstance(graph.log_trans, torch.Tensor) \
            and graph.log_trans.device == device:
        return graph
    return graph.to(device)


def _masked_mean(x, mask):
    if mask is None:
        return x.mean()
    return torch.sum(x * mask) / torch.clamp(mask.sum(), min=1.0)


def smbr_loss(logits, labels, graph, *, kappa: float = 0.3, mask=None):
    """logits (B,T,S) raw senone logits; labels (B,T) reference alignment.

    Returns (loss scalar, metrics dict).
    """
    g = _on(graph, logits.device)
    log_post = torch.log_softmax(logits.float(), dim=-1)
    log_obs = kappa * (log_post - g.log_prior[None, None])
    gamma, logz = forward_backward(log_obs, g.log_trans, g.log_init, mask)
    acc = torch.gather(gamma, -1, labels[..., None].long())[..., 0]
    eacc = _masked_mean(acc, mask)
    return -eacc, {"expected_frame_acc": eacc.detach(),
                   "log_z": logz.mean().detach()}


def make_smbr_loss_fn(model, cfg, graph, *, kappa: float = 0.3,
                      ce_smooth: float = 0.0):
    """Loss fn over the AM: hidden -> senone logits -> sMBR (+ CE smooth).

    -> loss_fn(params, batch) -> (loss, metrics); ``params`` a state
    dict, the batch's arrays moved to the parameters' device here.  The
    graph goes to that device once and stays there."""
    on_device = {}

    def loss_fn(params, batch):
        w = model.unembed_matrix(params)
        dev = w.device
        if dev not in on_device:
            on_device[dev] = _on(graph, dev)
        h, _ = model_forward(model, cfg, params,
                             {"feats": _tensor(batch["feats"], dev,
                                               torch.float32)})
        logits = (h @ w.to(h.dtype)).float()
        labels = _tensor(batch["labels"], dev, torch.int64)
        mask = batch.get("mask")
        mask = None if mask is None else _tensor(mask, dev, torch.float32)
        loss, metrics = smbr_loss(logits, labels, on_device[dev],
                                  kappa=kappa, mask=mask)
        if ce_smooth:
            lp = torch.log_softmax(logits, dim=-1)
            ce = _masked_mean(-torch.gather(lp, -1, labels[..., None])[..., 0],
                              mask)
            loss = (1 - ce_smooth) * loss + ce_smooth * ce
            metrics["ce"] = ce.detach()
        metrics["loss"] = loss.detach()
        return loss, metrics
    return loss_fn


def frame_error_rate(logits, labels, mask=None):
    """The WER proxy used by EXPERIMENTS.md (no LM decode in-container);
    ties take the first maximum, as the reference's argmax."""
    labels = torch.as_tensor(labels, device=logits.device)
    if mask is not None:
        mask = torch.as_tensor(mask, device=logits.device).float()
    err = (torch.argmax(logits, dim=-1) != labels).float()
    return _masked_mean(err, mask)
