"""Plain PyTorch version of the fused top-k/top-p Gumbel sampler.

The reference's ``kernels/topk_sample/ref.py`` defines the op's
semantics and the kernel is held to it exactly (vals, idx and the
sampled token).  It differs from ``serve/sampling.sample_tokens`` in one
documented way: the nucleus (top-p) mass is measured inside the
top-``k_cap`` candidate set (a renormalized softmax over k_cap values)
rather than over the full vocabulary, so the sampler never sorts a
(B, V) row.

Determinism contract shared with the kernel:

  * a stable descending sort and the kernel's max-extraction both break
    value ties toward the lower vocab index, so vals/idx agree bitwise;
  * the exclusive cumulative mass is a (k_cap, k_cap) strict-upper-
    triangular float32 matmul, as in the reference (its products are by
    0 and 1, so it is the rank-order sum the kernel takes);
  * the Gumbel noise is passed in (made once in ops.py from (seed,
    pos)), never re-derived per backend.

temperature <= 0 is the greedy sentinel per row: the returned token is
the first-maximum argmax of the row, bitwise.

``merge_runs_ref`` is the CUDA kernel's merge on the host: the run-head
merge of stage 1's sorted candidates, in the kernel's order.  No model
path calls it; the tests hold it against the reference to show that the
merge, given stage 1's candidates, is the row's top-k_cap bitwise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.topk_logits.ref import topk_logits_ref

NEG_INF = -1e30
_NO_HEAD = 2**32 - 1           # the kernel's position of no head (kNone)


def order_key(v: torch.Tensor) -> torch.Tensor:
    """The kernel's ``order_key`` on the float bits, as int64: unsigned
    keys in the order of the floats, -0 keyed as +0 (which compares equal
    to it)."""
    v = v.float()
    v = torch.where(v == 0, torch.zeros_like(v), v).contiguous()
    u = v.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(u >= 0x80000000, u ^ 0xFFFFFFFF, u | 0x80000000)


def merge_runs_ref(cand_v: torch.Tensor, cand_i: torch.Tensor, k_cap: int):
    """The kernel's merge: cand_v (R, C) f32 / cand_i (R, C) i32 as
    C / k_cap runs of k_cap, each sorted by (value desc, position asc) ->
    (vals (R, k_cap) f32, idx (R, k_cap) i32).

    k_cap rounds over the runs' heads: the largest ``order_key``, ties to
    the smallest position, then that run's head advances -- the two
    warp reductions of a round and the owner's step.  Values are the
    winners' own, sign bits included.
    """
    r, c = cand_v.shape
    if c % k_cap:
        raise ValueError(f"C={c} is not a multiple of k_cap={k_cap}")
    n_runs = c // k_cap
    dev = cand_v.device
    key = order_key(cand_v).reshape(r, n_runs, k_cap)
    head = torch.zeros((r, n_runs), dtype=torch.int64, device=dev)
    start = torch.arange(n_runs, device=dev) * k_cap
    picks = []
    for _ in range(k_cap):
        live = head < k_cap
        hk = key.gather(2, head.clamp(max=k_cap - 1)[..., None])[..., 0]
        hk = torch.where(live, hk, 0)
        hp = torch.where(live, start + head, _NO_HEAD)
        kmax = hk.max(dim=1, keepdim=True).values
        wpos = torch.where(hk == kmax, hp, _NO_HEAD).min(dim=1).values
        picks.append(wpos)
        head.scatter_add_(1, (wpos // k_cap)[:, None],
                          torch.ones_like(wpos)[:, None])
    pos = torch.stack(picks, dim=1)
    return cand_v.gather(1, pos).contiguous(), cand_i.gather(1, pos).contiguous()


def topk_sample_ref(logits, temperature=None, top_k=None, top_p=None,
                    gumbel=None, *, k_cap: int = 32, greedy: bool = False):
    """logits (B, V) -> (vals (B,k_cap) f32 desc, idx (B,k_cap) i32,
    token (B,) i32).

    ``greedy=True`` skips the sampling math: the token is the rank-0
    index.  Otherwise temperature/top_k/top_p are (B,) per-row knobs and
    ``gumbel`` is (B, k_cap) f32 noise applied by candidate rank.
    """
    vals, idx = topk_logits_ref(logits, k_cap)
    if greedy:
        return vals, idx, idx[:, 0].contiguous()
    dev = logits.device
    safe_t = torch.where(temperature > 0, temperature,
                         torch.ones_like(temperature))
    svals = vals / safe_t.float()[:, None]
    e = torch.exp(svals - svals[:, :1])            # rank 0 is the row max
    probs = e / e.sum(dim=1, keepdim=True)
    rank = torch.arange(k_cap, device=dev)
    tri = (rank[:, None] < rank[None, :]).float()
    excl = probs @ tri                             # mass before rank j
    k_eff = torch.where(top_k > 0, torch.clamp(top_k, max=k_cap),
                        torch.full_like(top_k, k_cap))
    keep = rank[None, :] < k_eff[:, None]
    keep &= excl < top_p[:, None]
    keep |= rank[None, :] == 0                     # rank 0 always sampleable
    pick = torch.argmax(torch.where(keep, svals, NEG_INF) + gumbel, dim=1)
    sampled = idx.gather(1, pick[:, None])[:, 0]
    token = torch.where(temperature > 0, sampled, idx[:, 0])
    return vals, idx, token.to(torch.int32)
