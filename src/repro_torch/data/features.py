"""Feature frontend (paper §2, faithfully):

  64-d log mel-warped energies, 10 ms hop / 25 ms window
  -> stack 3, subsample to a 30 ms advance (192-d)
  -> causal (running) mean subtraction
  -> global mean/variance normalization
  -> 3 feature offsets (0/1/2 frame start) to compensate sub-sampling.

Pure numpy: the feature pipeline is CPU-side in production too (the paper
parallelized it "over several thousand CPU cores"); jnp enters at the
trainer boundary.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from repro_torch.data.synthetic import SAMPLE_RATE, Utterance


@dataclass(frozen=True)
class FeatureConfig:
    n_mels: int = 64
    win_ms: float = 25.0
    hop_ms: float = 10.0
    stack: int = 3                   # frames stacked -> 30ms advance
    causal_mean_decay: float = 0.995
    n_offsets: int = 3
    fmin: float = 60.0
    fmax: float = 7600.0

    @property
    def stacked_dim(self) -> int:
        return self.n_mels * self.stack


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


def mel_filterbank(n_mels: int, n_fft: int, sr: int, fmin: float,
                   fmax: float) -> np.ndarray:
    """(n_mels, n_fft//2+1) triangular filters."""
    mels = np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2)
    freqs = _mel_to_hz(mels)
    bins = np.floor((n_fft + 1) * freqs / sr).astype(int)
    fb = np.zeros((n_mels, n_fft // 2 + 1))
    for m in range(1, n_mels + 1):
        l, c, r = bins[m - 1], bins[m], bins[m + 1]
        c = max(c, l + 1)
        r = max(r, c + 1)
        fb[m - 1, l:c] = (np.arange(l, c) - l) / (c - l)
        fb[m - 1, c:r] = (r - np.arange(c, r)) / (r - c)
    return fb


def log_mel(audio: np.ndarray, cfg: FeatureConfig) -> np.ndarray:
    """(n_samples,) -> (n_frames, n_mels) float32, 10ms frames."""
    win = int(SAMPLE_RATE * cfg.win_ms / 1000)
    hop = int(SAMPLE_RATE * cfg.hop_ms / 1000)
    n_fft = 1 << (win - 1).bit_length()
    if len(audio) < win:
        audio = np.pad(audio, (0, win - len(audio)))
    n_frames = 1 + (len(audio) - win) // hop
    idx = np.arange(win)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = audio[idx] * np.hanning(win)[None, :]
    spec = np.abs(np.fft.rfft(frames, n_fft, axis=-1)) ** 2
    fb = mel_filterbank(cfg.n_mels, n_fft, SAMPLE_RATE, cfg.fmin, cfg.fmax)
    return np.log(spec @ fb.T + 1e-10).astype(np.float32)


def stack_subsample(feats: np.ndarray, cfg: FeatureConfig, offset: int = 0
                    ) -> np.ndarray:
    """(T, M) -> (T', stack*M) with a `stack`-frame advance.

    `offset` in [0, stack): which 10ms phase the stacked stream starts on —
    the paper creates features at three offsets per utterance and rotates
    through them across epochs.
    """
    t = feats.shape[0]
    n = max(0, (t - offset) // cfg.stack)
    if n == 0:
        return np.zeros((1, cfg.stacked_dim), np.float32)
    f = feats[offset: offset + n * cfg.stack]
    return f.reshape(n, cfg.stacked_dim)


def causal_mean_norm(feats: np.ndarray, decay: float,
                     init_mean: Optional[np.ndarray] = None,
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Running (causal) cepstral-mean subtraction.

    The paper sorts a speaker's utterances and *carries the running mean
    across them* instead of requiring a pre-roll — ``init_mean`` is the
    carry.  Returns (normalized, final_mean).
    """
    mean = np.zeros(feats.shape[1], np.float64) if init_mean is None \
        else init_mean.astype(np.float64).copy()
    out = np.empty_like(feats)
    # scan: mean_t = decay*mean_{t-1} + (1-decay)*x_t  (vectorized via
    # exponential weights would lose the carry; T is small per utterance)
    for t in range(feats.shape[0]):
        mean = decay * mean + (1.0 - decay) * feats[t]
        out[t] = feats[t] - mean
    return out.astype(np.float32), mean


@dataclass
class GlobalMVN:
    mean: np.ndarray
    std: np.ndarray

    @classmethod
    def estimate(cls, feat_list) -> "GlobalMVN":
        cat = np.concatenate([f.reshape(-1, f.shape[-1]) for f in feat_list])
        return cls(mean=cat.mean(0), std=cat.std(0) + 1e-5)

    def __call__(self, feats: np.ndarray) -> np.ndarray:
        return ((feats - self.mean) / self.std).astype(np.float32)


def featurize(audio: np.ndarray, cfg: FeatureConfig, *, offset: int = 0,
              mvn: Optional[GlobalMVN] = None,
              carry_mean: Optional[np.ndarray] = None,
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Full frontend for one utterance -> ((T', stack*M), carry)."""
    lm = log_mel(audio, cfg)
    lm, carry = causal_mean_norm(lm, cfg.causal_mean_decay, carry_mean)
    st = stack_subsample(lm, cfg, offset)
    if mvn is not None:
        st = mvn(st)
    return st, carry


def align_labels(senones: np.ndarray, cfg: FeatureConfig, offset: int,
                 n_out: int, lookahead: int = 0) -> np.ndarray:
    """Subsample 10ms senone alignment to the stacked 30ms frame rate.

    Label of a stacked frame = senone at its center 10ms frame, *delayed*
    by ``lookahead`` stacked frames: with a 3-frame look-ahead the model
    emits the senone of frame t once it has seen frames up to t+3, i.e.
    the target at output index t is the senone of input frame t-3.
    """
    centers = offset + cfg.stack * np.arange(n_out) + cfg.stack // 2
    centers = np.clip(centers - lookahead * cfg.stack, 0,
                      len(senones) - 1)
    return senones[centers].astype(np.int32)


def featurize_utterance(utt: Utterance, cfg: FeatureConfig, *,
                        offset: int = 0, mvn: Optional[GlobalMVN] = None,
                        carry_mean: Optional[np.ndarray] = None,
                        lookahead: int = 0):
    """-> (feats (T', D), labels (T',), carry_mean)."""
    feats, carry = featurize(utt.audio, cfg, offset=offset, mvn=mvn,
                             carry_mean=carry_mean)
    labels = align_labels(utt.senones, cfg, offset, feats.shape[0],
                          lookahead)
    return feats, labels, carry
