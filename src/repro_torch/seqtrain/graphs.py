"""Denominator graph for sMBR: a senone-bigram HMM.

The twin of the reference's ``seqtrain/graphs.py``, host-side numpy, so
the same alignments give the same arrays, bit for bit, in either
package.  The production system uses a decoding-graph lattice; at
senone granularity the dense equivalent is an (S, S) transition matrix
with self-loops (HMM state persistence) and bigram senone transition
probabilities estimated from the labeled corpus' alignments -- the
synthetic twin of a phone-loop denominator.  S = 3,183 full / 97
reduced, so dense is fine (3183^2 f32 = 40 MB, resident once on the
card: ``to``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class DenominatorGraph:
    log_trans: np.ndarray        # (S,S) [from, to]
    log_init: np.ndarray         # (S,)
    log_prior: np.ndarray        # (S,) senone priors (for AM score scaling)
    n_senones: int

    def to(self, device) -> "DenominatorGraph":
        """The same graph with its arrays as float32 tensors on
        ``device`` (one copy, kept by the caller for every update)."""
        import torch

        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                   device=device)
        return DenominatorGraph(t(self.log_trans), t(self.log_init),
                                t(self.log_prior), self.n_senones)


def build_denominator_graph(alignments, n_senones: int, *,
                            self_loop: float = 0.7,
                            smoothing: float = 0.1) -> DenominatorGraph:
    """Estimate bigram transitions + priors from labeled alignments.

    alignments: iterable of (T,) int senone sequences.
    """
    counts = np.full((n_senones, n_senones), smoothing, np.float64)
    init = np.full((n_senones,), smoothing, np.float64)
    prior = np.full((n_senones,), smoothing, np.float64)
    for al in alignments:
        al = np.asarray(al)
        if len(al) == 0:
            continue
        init[al[0]] += 1
        prior += np.bincount(al, minlength=n_senones)
        changes = al[1:] != al[:-1]
        src = al[:-1][changes]
        dst = al[1:][changes]
        np.add.at(counts, (src, dst), 1.0)
    np.fill_diagonal(counts, 0.0)
    # rows: self-loop mass + (1-self_loop) distributed by bigram counts
    row = counts / counts.sum(1, keepdims=True)
    trans = (1.0 - self_loop) * row
    trans[np.arange(n_senones), np.arange(n_senones)] += self_loop
    return DenominatorGraph(
        log_trans=np.log(trans + 1e-30).astype(np.float32),
        log_init=np.log(init / init.sum()).astype(np.float32),
        log_prior=np.log(prior / prior.sum()).astype(np.float32),
        n_senones=n_senones)


def uniform_graph(n_senones: int, *, self_loop: float = 0.7
                  ) -> DenominatorGraph:
    off = (1.0 - self_loop) / (n_senones - 1)
    trans = np.full((n_senones, n_senones), off, np.float32)
    np.fill_diagonal(trans, self_loop)
    flat = np.full((n_senones,), 1.0 / n_senones, np.float32)
    return DenominatorGraph(np.log(trans), np.log(flat), np.log(flat),
                            n_senones)
