"""Forward-backward over a senone-level HMM, a loop over time.

Used by sMBR (paper §3.4): the denominator graph is a senone-bigram HMM
(``graphs.py``), the acoustic scores are scaled student
log-posteriors.  The twin of the reference's ``seqtrain/fb.py`` under
its public names, with its mask semantics: a frame with ``mask = 0``
carries alpha (and beta) through unchanged, and gamma is zeroed there.

The reference's step is ``logsumexp(alpha[:, :, None] + log_trans[None],
axis=1)``: a (B, S, S) tensor a step, which PyTorch's autograd would
keep for the backward (8 x 3,183^2 x 4 B = 324 MB a step; ~105 GB over
the forward and backward recursions of one 163-frame batch).  The
recursions here are the scaled form of the same sum instead:

    m      = max_i alpha[i]
    alpha' = log(exp(alpha - m) @ P) + m + obs,        P = exp(log_trans)

(and ``log(exp(beta + obs - m) @ P^T) + m`` backward), so a step keeps
O(B * S) and P (40.5 MB at S = 3,183) is shared by every step.  The
arithmetic is the reference's reordered: the terms that
``exp(alpha - m)`` flushes to zero lie more than 87 nats under the
row's largest, and the smallest transition probability of a smoothed
bigram graph at S = 3,183 is ~1e-5, so they are far below float32's
resolution of the sum.  The reference's literal step stays here as
``forward_backward_literal``, the plain version the scaled one is held
against (its (B, S, S) tensors fit without autograd at small B and T).
As in the reference's logsumexp, the shift ``m`` carries no gradient.
"""
from __future__ import annotations

import torch


def _mask(log_obs: torch.Tensor, mask) -> torch.Tensor:
    """(T, B) float mask, ones when ``mask`` is None."""
    b, t, _ = log_obs.shape
    if mask is None:
        return torch.ones((t, b), dtype=torch.float32,
                          device=log_obs.device)
    return torch.as_tensor(mask, device=log_obs.device).float().t()


def _forward_step(alpha, obs, trans):
    """log sum_i exp(alpha[i] + log_trans[i, j]) + obs[j], scaled."""
    m = alpha.amax(-1, keepdim=True).detach()
    return torch.log(torch.exp(alpha - m) @ trans) + m + obs


def _backward_step(beta, obs_next, trans):
    """log sum_j exp(log_trans[i, j] + beta[j] + obs_next[j]), scaled."""
    v = beta + obs_next
    m = v.amax(-1, keepdim=True).detach()
    return torch.log(torch.exp(v - m) @ trans.t()) + m


def _alphas(log_obs, trans, log_init, mk):
    """[alpha_0, ..., alpha_{T-1}], each (B, S)."""
    alpha = log_init[None] + log_obs[:, 0]
    out = [alpha]
    for t in range(1, log_obs.shape[1]):
        nxt = _forward_step(alpha, log_obs[:, t], trans)
        alpha = torch.where(mk[t][:, None] > 0, nxt, alpha)
        out.append(alpha)
    return out


def forward_log_norm(log_obs: torch.Tensor, log_trans: torch.Tensor,
                     log_init: torch.Tensor, mask=None) -> torch.Tensor:
    """log p(O) under the graph.

    log_obs (B,T,S); log_trans (S,S) [from, to]; log_init (S,).
    mask (B,T) 1=real frame.  Returns (B,) log-normalizer.
    """
    alpha = _alphas(log_obs, torch.exp(log_trans), log_init,
                    _mask(log_obs, mask))[-1]
    return torch.logsumexp(alpha, dim=-1)


def forward_backward(log_obs: torch.Tensor, log_trans: torch.Tensor,
                     log_init: torch.Tensor, mask=None):
    """State posteriors gamma (B,T,S) + log-normalizer (B,)."""
    b, t, s = log_obs.shape
    mk = _mask(log_obs, mask)
    trans = torch.exp(log_trans)
    alphas = torch.stack(_alphas(log_obs, trans, log_init, mk))  # (T,B,S)
    beta = torch.zeros((b, s), dtype=torch.float32, device=log_obs.device)
    betas = [beta]
    for i in range(t - 2, -1, -1):
        nxt = _backward_step(beta, log_obs[:, i + 1], trans)
        beta = torch.where(mk[i + 1][:, None] > 0, nxt, beta)
        betas.append(beta)
    betas = torch.stack(betas[::-1])                              # (T,B,S)
    return _posteriors(alphas, betas, mk)


def _posteriors(alphas, betas, mk):
    log_gamma = alphas + betas                                    # (T,B,S)
    logz = torch.logsumexp(log_gamma[0], dim=-1)                  # (B,)
    gamma = torch.exp(log_gamma - logz[None, :, None])
    gamma = gamma * mk[:, :, None]
    return gamma.transpose(0, 1), logz


def forward_backward_literal(log_obs: torch.Tensor, log_trans: torch.Tensor,
                             log_init: torch.Tensor, mask=None):
    """``forward_backward`` as the reference writes it: each step a
    logsumexp over a (B, S, S) tensor.  The plain version the scaled
    recursion is held against; O(B * S^2) a step, for small shapes and
    no autograd."""
    b, t, s = log_obs.shape
    mk = _mask(log_obs, mask)
    alpha = log_init[None] + log_obs[:, 0]
    alphas = [alpha]
    for i in range(1, t):
        nxt = torch.logsumexp(alpha[:, :, None] + log_trans[None], dim=1) \
            + log_obs[:, i]
        alpha = torch.where(mk[i][:, None] > 0, nxt, alpha)
        alphas.append(alpha)
    beta = torch.zeros((b, s), dtype=torch.float32, device=log_obs.device)
    betas = [beta]
    for i in range(t - 2, -1, -1):
        nxt = torch.logsumexp(
            log_trans[None] + (beta + log_obs[:, i + 1])[:, None, :], dim=2)
        beta = torch.where(mk[i + 1][:, None] > 0, nxt, beta)
        betas.append(beta)
    return _posteriors(torch.stack(alphas), torch.stack(betas[::-1]), mk)


def viterbi(log_obs: torch.Tensor, log_trans: torch.Tensor,
            log_init: torch.Tensor) -> torch.Tensor:
    """Best path (B,T) int32 -- used by the toy decoder / WER proxy.
    Each step's (B, S, S) scores are transient (no autograd); ties take
    the first maximum, as the reference's argmax."""
    delta = log_init[None] + log_obs[:, 0]
    args = []
    with torch.no_grad():
        for i in range(1, log_obs.shape[1]):
            scores = delta[:, :, None] + log_trans[None]          # (B,S,S)
            delta = scores.amax(dim=1) + log_obs[:, i]
            args.append(torch.argmax(scores, dim=1))
        state = torch.argmax(delta, dim=-1)                       # (B,)
        path = [state]
        for arg in reversed(args):
            state = torch.gather(arg, 1, state[:, None])[:, 0]
            path.append(state)
    return torch.stack(path[::-1], dim=1).to(torch.int32)
