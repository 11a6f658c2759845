"""Deterministic synthetic far-field speech generator (DESIGN.md §6).

Stands in for the paper's production Alexa audio: per-speaker formant-like
AR processes, device/noise conditions, and frame-level senone alignments
from a synthetic left-to-right HMM.  Everything is seeded — the same
(utt_id) always produces the same audio and alignment, so the corpus can be
"streamed" at any scale without storing it (this is exactly how we emulate
a 1M-hour firehose: utterance ids are the dataset).

Acoustic recipe (cheap but structured):
  speaker  -> 3 formant center freqs + AR(2) pole radii + f0
  senone   -> per-state formant perturbation + energy envelope
  device   -> room response proxy (one-pole lowpass + echo tap) + SNR range
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

SAMPLE_RATE = 16_000

# device placement / type distribution, loosely "similar to the labeled
# data" (paper §3.1)
DEVICES = ("near", "mid", "far", "noisy")
DEVICE_PROBS = (0.35, 0.30, 0.20, 0.15)
DEVICE_SNR_DB = {"near": (25.0, 35.0), "mid": (18.0, 28.0),
                 "far": (12.0, 22.0), "noisy": (6.0, 16.0)}


@dataclass(frozen=True)
class SynthConfig:
    n_speakers: int = 200
    n_phones: int = 42
    states_per_phone: int = 1          # low-frame-rate single-state units
    n_senones: int = 97                # clustered states (<= n_phones usually
                                       # not; senones = hashed (phone, ctx))
    mean_utt_sec: float = 2.0
    min_utt_sec: float = 0.6
    frame_ms: float = 10.0
    seed: int = 0


@dataclass
class Utterance:
    utt_id: int
    speaker: int
    device: str
    snr_db: float
    audio: np.ndarray                  # (n_samples,) float32
    senones: np.ndarray                # (n_frames,) int32, 10ms frames
    phones: np.ndarray                 # (n_phones_seq,) int32
    n_frames: int = 0

    def __post_init__(self):
        self.n_frames = len(self.senones)


def _rng(*salts: int) -> np.random.Generator:
    return np.random.default_rng(np.array(salts, np.uint64))


def _speaker_voice(speaker: int, seed: int):
    r = _rng(seed, 0xA5, speaker)
    formants = r.uniform([420, 1100, 2100], [620, 1500, 2700])
    f0 = r.uniform(90, 220)
    radius = r.uniform(0.93, 0.97)
    return formants, f0, radius


def senone_of(phone: int, left_ctx: int, n_senones: int) -> int:
    """Synthetic decision tree: deterministic hash of (phone, left context).

    Mimics triphone state clustering down to n_senones classes.
    """
    h = (phone * 1_000_003 + left_ctx * 7919 + 1) % 2_147_483_647
    return int(h % n_senones)


@functools.lru_cache(maxsize=8)
def _senone_codebooks(n_senones: int):
    """The per-senone formant directions and carrier amplitudes, the
    reference's arrays built once per senone count instead of once per
    utterance (read-only: callers index them)."""
    code = np.stack([np.random.default_rng(1000 + s).uniform(-1, 1, 3)
                     for s in range(n_senones)])
    amp_code = np.stack([np.random.default_rng(7000 + s_).uniform(0.1, 1.0, 4)
                         for s_ in range(n_senones)])
    code.flags.writeable = False
    amp_code.flags.writeable = False
    return code, amp_code


def synth_utterance(cfg: SynthConfig, utt_id: int) -> Utterance:
    r = _rng(cfg.seed, 0x5EED, utt_id)
    speaker = int(r.integers(cfg.n_speakers))
    device = str(r.choice(DEVICES, p=DEVICE_PROBS))
    lo, hi = DEVICE_SNR_DB[device]
    snr_db = float(r.uniform(lo, hi))

    dur = max(cfg.min_utt_sec, float(r.exponential(cfg.mean_utt_sec)))
    dur = min(dur, 4.0 * cfg.mean_utt_sec)
    n_frames = max(8, int(dur * 1000 / cfg.frame_ms))

    # phone sequence with random durations (geometric-ish, >=6 frames so
    # each senone spans >=2 stacked 30ms frames)
    phones, senones = [], []
    left = 0
    while len(senones) < n_frames:
        ph = int(r.integers(cfg.n_phones))
        d = int(np.clip(r.geometric(0.12), 6, 60))
        phones.append(ph)
        senones.extend([senone_of(ph, left, cfg.n_senones)] * d)
        left = ph
    senones = np.asarray(senones[:n_frames], np.int32)
    phones = np.asarray(phones, np.int32)

    # audio synthesis: per-frame AR filterbank excitation
    formants, f0, radius = _speaker_voice(speaker, cfg.seed)
    spf = int(SAMPLE_RATE * cfg.frame_ms / 1000)
    n = n_frames * spf
    t = np.arange(n) / SAMPLE_RATE
    # glottal-ish excitation: pulse train + noise
    exc = 0.6 * np.sign(np.sin(2 * np.pi * f0 * t)) * \
        (np.sin(2 * np.pi * f0 * t) ** 8) + 0.05 * r.standard_normal(n)
    # senone-dependent formant perturbation, piecewise constant per frame.
    # Speaker-INDEPENDENT by construction (the senone->acoustics map must
    # be consistent across speakers for the task to be learnable; speaker
    # identity enters via base formants/f0 only).  Per-senone directions
    # come from a hashed global codebook for maximal class spread.
    code, amp_code = _senone_codebooks(cfg.n_senones)
    pert = 1.0 + 0.4 * code[senones]
    sig = np.zeros(n)
    for fi in range(3):
        fr = np.repeat(formants[fi] * pert[:, fi], spf)
        # time-varying AR(2) resonator driven by exc
        w = 2 * np.pi * fr / SAMPLE_RATE
        a1 = 2 * radius * np.cos(w)
        a2 = -radius * radius
        y = np.zeros(n)
        y0 = y1 = 0.0
        # vectorize over frames: constant coefficients within a frame
        for f_ in range(n_frames):
            s0, s1 = f_ * spf, (f_ + 1) * spf
            aa1, aa2 = a1[s0], a2          # a2 is pole-radius const
            seg = exc[s0:s1]
            yy = np.empty(spf)
            for i, e in enumerate(seg):       # spf=160; fine for tests
                y2 = e + aa1 * y1 + aa2 * y0
                yy[i] = y2
                y0, y1 = y1, y2
            y[s0:s1] = yy
        sig += y / 3.0

    # senone-coded narrowband component: per-senone amplitude pattern over
    # four fixed carrier bands (formant-like spectral envelope cues).  The
    # resonator chain alone leaves too little class information after the
    # mel frontend at laptop scale; this keeps the task audio-realistic
    # (everything still flows audio -> log-mel -> model) AND learnable.
    carriers = np.array([500.0, 1100.0, 1900.0, 3100.0])
    amps = amp_code[senones]                       # (n_frames, 4)
    tone = np.zeros(n)
    for j, fc in enumerate(carriers):
        tone += np.repeat(amps[:, j], spf) * np.sin(2 * np.pi * fc * t)
    sig = sig + 0.5 * tone

    # device channel: lowpass + echo tap, then noise at the drawn SNR
    alpha = {"near": 0.1, "mid": 0.3, "far": 0.5, "noisy": 0.45}[device]
    filt = np.copy(sig)
    filt[1:] += alpha * sig[:-1]
    echo_delay = {"near": 0, "mid": 400, "far": 1200, "noisy": 800}[device]
    if echo_delay:
        filt[echo_delay:] += 0.3 * sig[:-echo_delay]
    p_sig = np.mean(filt ** 2) + 1e-12
    p_noise = p_sig / (10 ** (snr_db / 10))
    audio = filt + np.sqrt(p_noise) * r.standard_normal(n)
    audio = (audio / (np.max(np.abs(audio)) + 1e-9)).astype(np.float32)

    return Utterance(utt_id=utt_id, speaker=speaker, device=device,
                     snr_db=snr_db, audio=audio, senones=senones,
                     phones=phones)


def synth_corpus(cfg: SynthConfig, n_utts: int, *, start_id: int = 0
                 ) -> List[Utterance]:
    return [synth_utterance(cfg, start_id + i) for i in range(n_utts)]


def corpus_hours(utts: List[Utterance]) -> float:
    return sum(u.audio.shape[0] for u in utts) / SAMPLE_RATE / 3600.0
