"""Chunked BPTT batching (paper §2):

"utterances are split into smaller sub-sequence chunks (here, 32 frames)
and the sub-sequences are randomized" — greater parallelization efficiency
for the early sub-epochs; full-sequence BPTT for fine-tuning.

Chunks carry (utt_id, chunk_index) so a stateful trainer *could* thread
LSTM state; the paper resets state per chunk (that is the efficiency
trade), which is what ``chunk_utterances`` produces.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class Chunk:
    feats: np.ndarray          # (chunk_len, D)
    labels: np.ndarray         # (chunk_len,)  (or top-k target rows)
    utt_id: int
    chunk_index: int
    valid: int                 # frames before padding


def chunk_utterances(feat_label_pairs: Sequence[Tuple[np.ndarray, np.ndarray, int]],
                     chunk_len: int = 32, *, rng: Optional[np.random.Generator] = None,
                     drop_last_partial: bool = False) -> List[Chunk]:
    """[(feats (T,D), labels (T,), utt_id)] -> randomized list of Chunks."""
    chunks: List[Chunk] = []
    for feats, labels, utt_id in feat_label_pairs:
        t = feats.shape[0]
        n = t // chunk_len if drop_last_partial else (t + chunk_len - 1) // chunk_len
        for ci in range(max(n, 0)):
            s = ci * chunk_len
            e = min(s + chunk_len, t)
            f = feats[s:e]
            l = labels[s:e]
            valid = e - s
            if valid < chunk_len:
                f = np.pad(f, ((0, chunk_len - valid), (0, 0)))
                l = np.pad(l, (0, chunk_len - valid))
            chunks.append(Chunk(f, l, utt_id, ci, valid))
    if rng is not None:
        rng.shuffle(chunks)
    return chunks


def batch_chunks(chunks: Sequence[Chunk], batch_size: int
                 ) -> Iterator[dict]:
    """Yield {'feats' (B,L,D), 'labels' (B,L), 'mask' (B,L)} dicts."""
    for s in range(0, len(chunks) - batch_size + 1, batch_size):
        group = chunks[s: s + batch_size]
        feats = np.stack([c.feats for c in group])
        labels = np.stack([c.labels for c in group])
        mask = np.zeros(labels.shape, np.float32)
        for i, c in enumerate(group):
            mask[i, :c.valid] = 1.0
        yield {"feats": feats, "labels": labels, "mask": mask}


def pad_batch(feat_label_pairs: Sequence[Tuple[np.ndarray, np.ndarray, int]],
              *, max_len: Optional[int] = None) -> dict:
    """Full-sequence batch: pad to the longest (or max_len) utterance."""
    t = max(f.shape[0] for f, _, _ in feat_label_pairs)
    if max_len is not None:
        t = min(t, max_len)
    b = len(feat_label_pairs)
    d = feat_label_pairs[0][0].shape[1]
    feats = np.zeros((b, t, d), np.float32)
    labels = np.zeros((b, t), np.int32)
    mask = np.zeros((b, t), np.float32)
    for i, (f, l, _) in enumerate(feat_label_pairs):
        n = min(f.shape[0], t)
        feats[i, :n] = f[:n]
        labels[i, :n] = l[:n]
        mask[i, :n] = 1.0
    return {"feats": feats, "labels": labels, "mask": mask}
