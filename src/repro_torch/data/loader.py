"""Corpus loader (paper §3.1):

"a feature pipeline that uses an efficient hashing mechanism to cluster
speakers and sort utterances belonging to a speaker for performing running
cepstral mean normalization. This could then be parallelized over several
thousand CPU cores."

``speaker_hash`` buckets speakers onto workers; each worker sorts its
utterances by (speaker, utt_id) and carries the causal mean across a
speaker's utterances.  No pre-roll needed — exactly the paper's trick.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

import numpy as np

from repro_torch.data import features as F
from repro_torch.data.chunking import batch_chunks, chunk_utterances, pad_batch
from repro_torch.data.synthetic import SynthConfig, Utterance, synth_utterance


def speaker_hash(speaker: int, n_buckets: int) -> int:
    """Stable speaker -> worker-bucket assignment."""
    h = hashlib.blake2b(int(speaker).to_bytes(8, "little"),
                        digest_size=8).digest()
    return int.from_bytes(h, "little") % n_buckets


@dataclass
class CorpusLoader:
    """Streams featurized batches from the (synthetic) firehose.

    One loader per worker: it draws the utterance-id range assigned to the
    worker, keeps only speakers hashing into its bucket, sorts per speaker,
    and threads the running-CMN carry across a speaker's utterances.
    """
    synth: SynthConfig
    feat: F.FeatureConfig = field(default_factory=F.FeatureConfig)
    worker: int = 0
    n_workers: int = 1
    lookahead: int = 0
    mvn: Optional[F.GlobalMVN] = None

    def estimate_mvn(self, n_utts: int = 24) -> F.GlobalMVN:
        feats = []
        for uid in range(n_utts):
            u = synth_utterance(self.synth, uid)
            f, _ = F.featurize(u.audio, self.feat)
            feats.append(f)
        self.mvn = F.GlobalMVN.estimate(feats)
        return self.mvn

    def _utts_for_range(self, start: int, count: int) -> List[Utterance]:
        mine = []
        for uid in range(start, start + count):
            u = synth_utterance(self.synth, uid)
            if speaker_hash(u.speaker, self.n_workers) == self.worker:
                mine.append(u)
        # sort utterances belonging to a speaker (running CMN order)
        mine.sort(key=lambda u: (u.speaker, u.utt_id))
        return mine

    def featurized(self, start: int, count: int, *, offset: int = 0):
        """-> [(feats, labels, utt_id)] with per-speaker CMN carry."""
        carries: Dict[int, np.ndarray] = {}
        out = []
        for u in self._utts_for_range(start, count):
            f, l, carry = F.featurize_utterance(
                u, self.feat, offset=offset, mvn=self.mvn,
                carry_mean=carries.get(u.speaker), lookahead=self.lookahead)
            carries[u.speaker] = carry
            out.append((f, l, u.utt_id))
        return out

    # ------------------------------------------------------------ batches

    def chunked_batches(self, start: int, count: int, *, batch_size: int,
                        chunk_len: int = 32, offset: int = 0,
                        seed: int = 0) -> Iterator[dict]:
        pairs = self.featurized(start, count, offset=offset)
        rng = np.random.default_rng(seed)
        chunks = chunk_utterances(pairs, chunk_len, rng=rng)
        yield from batch_chunks(chunks, batch_size)

    def full_seq_batches(self, start: int, count: int, *, batch_size: int,
                         offset: int = 0, max_len: Optional[int] = None
                         ) -> Iterator[dict]:
        yield from full_seq_batches_of(
            self.featurized(start, count, offset=offset),
            batch_size=batch_size, max_len=max_len)


def full_seq_batches_of(pairs, *, batch_size: int,
                        max_len: Optional[int] = None) -> Iterator[dict]:
    """Full-sequence batches of ``batch_size`` featurized ``(feats,
    labels, utt_id)`` pairs, in order; a partial last batch is dropped."""
    for s in range(0, len(pairs) - batch_size + 1, batch_size):
        yield pad_batch(pairs[s: s + batch_size], max_len=max_len)


def token_batches(vocab: int, batch: int, seq: int, n_batches: int,
                  seed: int = 0) -> Iterator[dict]:
    """Synthetic token batches for the LLM-arch examples/tests."""
    rng = np.random.default_rng(seed)
    for _ in range(n_batches):
        toks = rng.integers(0, vocab, (batch, seq + 1), dtype=np.int32)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
