"""Per-request sampling for the continuous-batching decode window.

``sample_tokens`` runs inside the ``sync_every``-step window, so
everything is vectorised over rows and stays on the device: temperature,
top-k, top-p and seed arrive as (B,) tensors chosen per request at
admission.

Reproducibility contract: the Gumbel noise for row b at position p is a
pure function of ``(seed_b, p)`` — the reference's
``gumbel(fold_in(PRNGKey(seed_b), p))``, drawn by the port's threefry
twin (``utils/threefry.py``) — never of the batch composition or wall
clock.  The same request replayed solo, in a different slot, or next to
different neighbours samples the same tokens, and the same tokens as the
reference wherever no two scores lie within the last bit of ``log``.
``temperature <= 0`` is the greedy sentinel: that row takes argmax
bitwise, so mixing greedy and sampled requests in one window is safe.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.utils import threefry

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request knobs. Defaults are greedy (temperature 0)."""
    temperature: float = 0.0
    top_k: int = 0          # 0 = no top-k cut
    top_p: float = 1.0      # 1.0 = no nucleus cut
    seed: int = 0

    def __post_init__(self):
        if self.top_k < 0:
            raise ValueError("top_k must be >= 0 (0 disables)")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")

    @property
    def greedy(self):
        return self.temperature <= 0.0


GREEDY = SamplingParams()


def sample_tokens(logits, temperature, top_k, top_p, seeds, pos):
    """Sample one token per row.  logits (B, V) float; temperature /
    top_p (B,) float; top_k / seeds / pos (B,) int.  Returns (B,) int32.

    One descending sort per step covers both filters: top-k keeps ranks
    < k, top-p keeps the shortest prefix whose mass reaches top_p (the
    ``cum - probs < top_p`` form always keeps rank 0, so a peaked
    distribution can never mask everything).  Selection is Gumbel-max
    over the surviving ranks, mapped back through the sort order.  The
    sort is stable, as ``jnp.argsort`` is, so equal logits keep id
    order.
    """
    b, v = logits.shape
    logits = logits.float()
    greedy_tok = torch.argmax(logits, dim=-1).to(torch.int32)

    safe_t = torch.where(temperature > 0, temperature,
                         torch.ones_like(temperature)).float()
    scaled = logits / safe_t[:, None]
    order = torch.argsort(-scaled, dim=-1, stable=True)      # (B, V) desc
    svals = scaled.gather(-1, order)
    probs = torch.softmax(svals, dim=-1)
    cum = torch.cumsum(probs, dim=-1)

    k_eff = torch.where(top_k > 0, top_k, torch.full_like(top_k, v))
    keep = torch.arange(v, device=logits.device)[None, :] < k_eff[:, None]
    keep &= (cum - probs) < top_p[:, None]
    keep[:, 0] = True
    masked = torch.where(keep, svals, NEG_INF)

    g = threefry.gumbel(seeds, pos, v)
    pick = torch.argmax(masked + g, dim=-1)
    sampled = order.gather(-1, pick[:, None])[:, 0]
    return torch.where(temperature > 0, sampled,
                       greedy_tok).to(torch.int32)
