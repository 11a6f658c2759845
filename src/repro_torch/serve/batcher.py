"""Dynamic bucketing / padding-aware batch formation (host-only; the
port's copy of the reference's ``serve/batcher.py``).

The cost of a padded batch is ``B * T_bucket`` frames of compute for
``sum(lens)`` useful frames.  The batcher keeps the reference's shape
discipline (few distinct (B, T_bucket) shapes — one compiled program
each there, one set of kernel shapes here) and trades it against
padding:

  * lengths are rounded up to a multiple of ``bucket_multiple``,
  * requests are sorted by length and greedily packed so near-equal
    lengths share a batch (little padding waste),
  * the batch dim is always padded to ``max_batch`` with zero-length
    dummy rows (exactly one (B, T) shape per bucket length; masked rows
    cost compute — the standard serving trade).

Two shipped policies mirror the engine's two consumers: THROUGHPUT packs
big batches for the teacher's offline firehose (paper §3.2.2 target
generation); LATENCY keeps batches small and never waits for more work
than the queue already holds, for online serving.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serve.request import InferenceRequest


@dataclass(frozen=True)
class BatchPolicy:
    """How the batcher groups pending requests.

    max_batch: rows per formed batch (batch dim is padded to this); for
        the token server this is the continuous batcher's slot count.
    bucket_multiple: time-length rounding quantum (padding/shape-count trade).
    sort_by_length: pack near-equal lengths together (throughput) or
        preserve arrival order (latency fairness).
    sync_every: the token server's decode-window length — fused device
        steps between host syncs (admit/retire cadence).  Small keeps
        first-token latency low; large amortizes host syncs.
    """
    name: str
    max_batch: int = 16
    bucket_multiple: int = 64
    sort_by_length: bool = True
    sync_every: int = 8


THROUGHPUT = BatchPolicy("throughput", max_batch=16, bucket_multiple=64,
                         sort_by_length=True, sync_every=16)
LATENCY = BatchPolicy("latency", max_batch=4, bucket_multiple=16,
                      sort_by_length=False, sync_every=4)


@dataclass(frozen=True)
class SLOTier:
    """One service tier of the slot-based session core.

    name: the tier id sessions carry (``payload.tier``).
    sync_every: this tier's decode-window length.  The core runs the
        *tightest* window among active tiers — one interactive session
        shortens the window for everyone, keeping its emission latency
        bounded; a firehose-only batch runs long windows that amortize
        host syncs.
    max_batch: cap on slots this tier may hold concurrently (None = up
        to the whole server) — the per-tier analogue of
        ``BatchPolicy.max_batch``.
    preemptible: under interactive pressure this tier's sessions are
        shed (admission deferred) or parked (detached mid-flight, state
        pulled to host, slot re-admitted to waiting work).
    """
    name: str
    sync_every: int = 8
    max_batch: Optional[int] = None
    preemptible: bool = False


INTERACTIVE = SLOTier("interactive", sync_every=2, preemptible=False)
FIREHOSE = SLOTier("firehose", sync_every=16, preemptible=True)


@dataclass(frozen=True)
class TieredPolicy:
    """SLO-aware admission policy over a set of tiers.

    shed_threshold: once non-preemptible (interactive) sessions occupy
        this fraction of slots, preemptible (firehose) admissions stop
        — queued firehose sessions stay pending ("shed"), and
        ``SlotServer._rebalance`` parks active ones when interactive
        sessions are waiting with no free slot.
    """
    tiers: Tuple[SLOTier, ...] = (INTERACTIVE, FIREHOSE)
    shed_threshold: float = 0.75

    def __post_init__(self):
        if not self.tiers:
            raise ValueError("need at least one tier")
        if not 0.0 < self.shed_threshold <= 1.0:
            raise ValueError("shed_threshold must be in (0, 1]")
        names = [t.name for t in self.tiers]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tier names in {names}")

    def tier(self, name: Optional[str]) -> SLOTier:
        """Look up a tier; None (untagged session) maps to the first
        (default) tier."""
        if name is None:
            return self.tiers[0]
        for t in self.tiers:
            if t.name == name:
                return t
        raise KeyError(f"unknown tier {name!r}; have "
                       f"{[t.name for t in self.tiers]}")


SLO_DEFAULT = TieredPolicy()


def bucket_length(t: int, multiple: int) -> int:
    """Round t up to the bucket grid (at least one multiple)."""
    return max(multiple, ((t + multiple - 1) // multiple) * multiple)


@dataclass
class FormedBatch:
    """A padded, mask-annotated batch ready for one engine forward."""
    requests: List[InferenceRequest]
    feats: np.ndarray               # (max_batch, T_bucket, F) float32
    lens: np.ndarray                # (max_batch,) int32; 0 for dummy rows

    @property
    def n_real(self) -> int:
        return len(self.requests)

    @property
    def frames(self) -> int:
        return int(self.lens.sum())

    @property
    def padded_frames(self) -> int:
        return int(self.feats.shape[0] * self.feats.shape[1])


def form_batches(requests: Sequence[InferenceRequest],
                 policy: BatchPolicy) -> List[FormedBatch]:
    """Group requests into padded batches under the policy.

    Every request appears in exactly one batch; within a batch, rows are
    padded to the longest member's bucketed length.
    """
    if not requests:
        return []
    order = list(requests)
    if policy.sort_by_length:
        # stable: equal lengths keep arrival order
        order.sort(key=lambda r: r.length)
    feat_dim = order[0].feats.shape[1]

    batches: List[FormedBatch] = []
    for lo in range(0, len(order), policy.max_batch):
        group = order[lo:lo + policy.max_batch]
        t_bucket = bucket_length(max(r.length for r in group),
                                 policy.bucket_multiple)
        feats = np.zeros((policy.max_batch, t_bucket, feat_dim), np.float32)
        lens = np.zeros((policy.max_batch,), np.int32)
        for i, r in enumerate(group):
            feats[i, :r.length] = r.feats
            lens[i] = r.length
        batches.append(FormedBatch(group, feats, lens))
    return batches


def padding_efficiency(batches) -> float:
    """Useful work / computed work — ONE honest number for every
    serving surface.

    Accepts a sequence of ``FormedBatch`` (the batch path: useful vs
    padded frames), or a slot-server stats dict (``SlotServer.stats``:
    ``useful_units`` vs ``padded_units``, where the denominator already
    counts empty slots, retired-row overshoot and chunk-level dead rows
    of streaming sessions — a parked stream's idle window is waste, not
    invisible).
    """
    if isinstance(batches, dict):
        return batches["useful_units"] / max(batches["padded_units"], 1)
    useful = sum(b.frames for b in batches)
    total = sum(b.padded_frames for b in batches)
    return useful / max(total, 1)
