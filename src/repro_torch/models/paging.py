"""Device-side paged KV-cache layout (vLLM-style block tables).

The twin of the reference's ``models/paging.py``.  A paged decode cache
replaces the contiguous per-row ``(B, Hkv, max_seq, hd)`` KV region with
a shared **pool** of fixed-size pages plus a per-row **block table**
mapping logical block -> physical page:

  * each pageable layer stores one pool of ``(n_pages + 1) * page_size``
    token slots and no batch axis: ``(pool_slots, n_kv_heads, head_dim)``
    (an MLA layer its two latent pools, ``(pool_slots, kv_lora_rank)``
    and ``(pool_slots, qk_rope_head_dim)``);
  * one block table ``(B, max_blocks) int32`` and per-row capacities
    ``(B,) int32`` live in the cache root (``cache["pages"]``) and are
    shared by every pageable layer — each layer has its own pool, all
    pools use the same page ids;
  * **page 0 is a reserved trash page**: the host allocator
    (``serve/paging.py``) hands out ids ``1..n_pages`` only, and empty or
    retired slots (table row zeroed, cap 0) read and write page 0 — a
    window's overshoot never reaches another row's pages.

Only full-context attention layers page.  Sliding-window rings are
already bounded to ``window`` slots, so they keep their contiguous
per-row layout.

Writes are in place (``index_copy_`` into the pool), as the port's
``attention.row_update`` is, where the reference writes a one-hot
product and a select.  Slots that one row writes are its own, so the
values are the reference's everywhere but in trash page 0: where several
rows land there in one step the reference keeps their sum and an
in-place write keeps one of them.  No valid read ever covers page 0, so
tokens and every other slot are the same; tests that compare pools
leave page 0 out.  A read gathers each row's ``max_ctx`` logical slots
into the same ``(B, Hkv, S, hd)`` layout the contiguous tail consumes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch


@dataclass(frozen=True)
class PagedCacheConfig:
    """Static paging geometry (host and device agree on it).

    page_size: token positions per page.
    n_pages: allocatable pages in every layer pool (page 0 is extra and
        reserved as the trash page).
    max_ctx: logical per-row context capacity (block-table width *
        page_size).  0 -> ``n_pages * page_size`` (one row may own the
        whole pool).
    """
    page_size: int = 16
    n_pages: int = 64
    max_ctx: int = 0

    def __post_init__(self):
        if self.page_size < 1 or self.n_pages < 1:
            raise ValueError("page_size and n_pages must be >= 1")
        if self.max_ctx % self.page_size:
            raise ValueError(
                f"max_ctx ({self.max_ctx}) must be a multiple of "
                f"page_size ({self.page_size})")

    @property
    def resolved_max_ctx(self) -> int:
        return self.max_ctx or self.n_pages * self.page_size

    @property
    def max_blocks(self) -> int:
        return self.resolved_max_ctx // self.page_size

    @property
    def pool_slots(self) -> int:
        # +1: page 0, the trash page
        return (self.n_pages + 1) * self.page_size


class PageRef(NamedTuple):
    """The device view of the shared block table, built by
    ``decode_step`` from ``cache["pages"]``."""
    tables: torch.Tensor           # (B, max_blocks) int32, 0 = trash page
    caps: torch.Tensor             # (B,) int32 allocated positions per row
    page_size: int


class StepSlots(NamedTuple):
    """One decode step's pool slots, the same for every pageable layer:
    ``decode_step`` computes them once (``step_slots``) and each layer
    writes and gathers through them."""
    write: torch.Tensor            # (B,) int64, write_index
    gather: torch.Tensor           # (B, max_ctx) int64, gather_indices


def is_paged_spec(spec) -> bool:
    """Does this attention-family LayerSpec page?  Windowed swa layers
    keep their contiguous ring (already bounded to ``window`` slots)."""
    return not (spec.mixer == "swa" and spec.window)


def prefix_sharing_supported(cfg) -> bool:
    """Prefix pages may only be shared when the whole cross-token state
    of a prompt position lives in pageable pools.  An swa ring, a
    recurrent state or encoder cross-attention would start a prefix-hit
    row with stale or zero non-paged state, so those archs admit at
    position 0 (no sharing) instead of returning wrong tokens."""
    if cfg.encoder is not None or cfg.family == "lstm_am":
        return False
    for seg in cfg.segments:
        for sp in seg.pattern:
            if sp.mixer not in ("attn", "swa") or not is_paged_spec(sp):
                return False
    return True


def paged_token_bytes(cfg, dtype: torch.dtype) -> int:
    """Bytes of pool storage one token position occupies across every
    pageable layer, for a cache of torch ``dtype``."""
    item = torch.empty((), dtype=dtype).element_size()
    total = 0
    for seg in cfg.segments:
        for sp in seg.pattern:
            if sp.mixer in ("attn", "swa") and is_paged_spec(sp):
                if cfg.mla is not None:
                    per = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
                else:
                    per = 2 * cfg.n_kv_heads * cfg.resolved_head_dim
                total += seg.repeat * per * item
    if cfg.encoder is not None:
        # whisper decoder self-attention K/V
        total = cfg.n_layers * 2 * cfg.n_kv_heads * cfg.resolved_head_dim \
            * item
    return total


# --------------------------------------------------------- device helpers

def write_index(pages: PageRef, pos: torch.Tensor) -> torch.Tensor:
    """(B,) flat pool slot where each row writes position ``pos``.

    The position is clamped into the row's allocation: rows past their
    capacity (retired slots overshooting until the next host sync)
    rewrite their own last slot, and rows with cap 0 (empty slots, table
    row zeroed) land in trash page 0 — never in another row's pages."""
    ps = pages.page_size
    hi = torch.clamp(pages.caps - 1, min=0)
    lpos = torch.minimum(torch.clamp(pos, min=0), hi).long()
    page = pages.tables.gather(1, (lpos // ps)[:, None])[:, 0].long()
    return page * ps + lpos % ps


def gather_indices(pages: PageRef) -> torch.Tensor:
    """(B, max_blocks * page_size) flat pool slot of every logical
    position — unallocated blocks (table entry 0) read the trash page
    and are masked by the ``<= pos`` validity check downstream."""
    ps = pages.page_size
    b, nb = pages.tables.shape
    flat = pages.tables.long()[:, :, None] * ps \
        + torch.arange(ps, device=pages.tables.device)[None, None, :]
    return flat.reshape(b, nb * ps)


def step_slots(pages: PageRef, pos: torch.Tensor) -> StepSlots:
    """The slots of a step at ``pos``: where each row writes, and every
    logical position each row reads."""
    return StepSlots(write_index(pages, pos), gather_indices(pages))


def pool_write(pool: torch.Tensor, new: torch.Tensor,
               flat_idx: torch.Tensor) -> torch.Tensor:
    """Write ``new[b]`` (leading dim B) into ``pool[flat_idx[b]]``, in
    place; returns ``pool``.  Rows of one batch target disjoint slots
    (disjoint allocations) except in trash page 0, where one of the
    colliding rows' values stays (the reference sums them there)."""
    return pool.index_copy_(0, flat_idx.long(), new.to(pool.dtype))


def gather_pool(pool: torch.Tensor, flat_idx: torch.Tensor) -> torch.Tensor:
    """Each row's logical context, contiguous: ``pool`` read at
    ``flat_idx`` (B, S) int64.  A KV pool (pool_slots, Hkv, hd) gives
    (B, Hkv, S, hd); a latent pool (pool_slots, d) (MLA's) gives
    (B, S, d)."""
    b, s = flat_idx.shape
    rows = pool.index_select(0, flat_idx.reshape(-1))
    if pool.dim() == 2:
        return rows.view(b, s, pool.shape[1])
    return rows.view(b, s, *pool.shape[1:]).transpose(1, 2).contiguous()
