"""Scheduled learning (paper §3.3): interleave unlabeled sub-epochs with
labeled passes, exponential LR decay over sub-epochs, chunked-BPTT for early
sub-epochs then full-sequence fine-tuning, rotating feature offsets on
labeled passes.

Paper schedules:
  100k hours: 4 sub-epochs x 25k hrs; labeled pass after EVERY sub-epoch;
              chunked BPTT for sub-epochs 1-3, full-sequence on the 4th.
  1M hours:   18 sub-epochs x ~55k hrs; labeled pass after every 5th;
              chunked for sub-epochs 1-15, fine-tune (full seq) on 16-18.
The generator below emits phase descriptors that a trainer consumes; sizes
are configurable so small runs keep the exact *structure*.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List


@dataclass(frozen=True)
class Phase:
    kind: str                 # "unlabeled" | "labeled"
    sub_epoch: int            # 1-based index over unlabeled sub-epochs
    lr: float
    chunked: bool             # chunked BPTT (32-frame) vs full-sequence
    feature_offset: int       # 0/1/2 rotation on labeled passes (paper §2)
    hours: float


@dataclass
class ScheduleConfig:
    n_sub_epochs: int = 18
    sub_epoch_hours: float = 55_000.0
    labeled_hours: float = 7_000.0
    labeled_every: int = 5            # labeled pass after every N sub-epochs
    chunked_until: int = 15           # sub-epochs > this run full-sequence
    lr0: float = 5e-4
    lr_decay: float = 0.85            # exponential decay per sub-epoch
    labeled_lr_boost: float = 1.5     # "slightly higher learning rates on
                                      #  the labeled data"
    n_feature_offsets: int = 3

    @classmethod
    def paper_100k(cls, **kw) -> "ScheduleConfig":
        return cls(n_sub_epochs=4, sub_epoch_hours=25_000.0,
                   labeled_every=1, chunked_until=3, **kw)

    @classmethod
    def paper_1m(cls, **kw) -> "ScheduleConfig":
        return cls(n_sub_epochs=18, sub_epoch_hours=55_000.0,
                   labeled_every=5, chunked_until=15, **kw)


def schedule(cfg: ScheduleConfig) -> Iterator[Phase]:
    """Yield the interleaved phase sequence."""
    offset = 0
    for se in range(1, cfg.n_sub_epochs + 1):
        lr = cfg.lr0 * (cfg.lr_decay ** (se - 1))
        chunked = se <= cfg.chunked_until
        yield Phase("unlabeled", se, lr, chunked, -1, cfg.sub_epoch_hours)
        if se % cfg.labeled_every == 0 or se == cfg.n_sub_epochs:
            yield Phase("labeled", se, lr * cfg.labeled_lr_boost, chunked,
                        offset, cfg.labeled_hours)
            offset = (offset + 1) % cfg.n_feature_offsets


def phases(cfg: ScheduleConfig) -> List[Phase]:
    return list(schedule(cfg))


def describe(cfg: ScheduleConfig) -> str:
    out = []
    for p in phases(cfg):
        out.append(f"sub-epoch {p.sub_epoch:2d} {p.kind:9s} "
                   f"lr={p.lr:.2e} {'chunked' if p.chunked else 'full-seq'}"
                   + (f" offset={p.feature_offset}" if p.kind == "labeled"
                      else ""))
    return "\n".join(out)
