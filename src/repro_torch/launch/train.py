"""Trainer CLI: the paper's baseline, teacher, target generation,
student and sMBR stages on the card.

The twin of the reference's ``launch/train.py`` for ``--arch
lstm-am-7khr`` at five stages of ``core/ssl_pipeline.py``, with random
weights from ``--seed``:

``--stage baseline`` (``stage_baseline``, paper §2): the student CE-trained
under ``Local()`` on the port's copy of the reference's seeded synthetic
corpus (``repro_torch.data``), as the reference's ``_ce_source``:
chunked-BPTT epochs with the feature offset rotating by ``ep % 3`` and
the chunk shuffle seeded by ``ep``, then one full-sequence fine-tune
epoch at ``lr * 0.3``.  Final params in ``<out>/ckpt_baseline``; the
results carry ``val_fer``, the frame error rate on the held-out
utterances (ids from 100,000).

``--stage teacher`` (``stage_teacher``, §3.2): the biLSTM teacher
(``seed + 1``) CE-fit on the same corpus (the chunk shuffle seeded from
100), then one epoch of sMBR fine-tune (``seqtrain``, kappa 0.3) over
the full-sequence labeled batches under ``Local(clip=0.0)`` at lr 5e-3.
Its two Trainers (``teacher``, ``teacher_smbr``) are finalized only at
the stage's end, so a stage killed in the sMBR sub-fit resumes that
sub-fit.  Final params in ``<out>/ckpt_teacher``.

``--stage targets`` (``stage_targets``, paper §3.2.2 "parallelize target
generation"):
  (a) the teacher is ``<out>/ckpt_teacher`` when it holds one (the
      trained teacher of ``--stage teacher``); else a random-init one
      (``lstm-am-teacher``, biLSTM, seed + 1) is written there;
  (b) ``--workers`` in-process workers, each with its own
      ``TeacherRunner`` rebuilt from that checkpoint, run
      ``pipeline.generate_sharded`` over ragged unlabeled batches into
      the manifest-backed ``LogitStoreV2(<out>/logit_store)`` (the
      ``topk_logits`` kernel, one launch a batch), ledgered in
      ``<out>/gen_ledger.json``: a killed run resumes its unfinished
      ranges, a completed one is superseded by the next wave;
  (c) ``store.verify()`` checksums every shard; the report (the
      reference's keys, which teacher ran, frames/s of generation, the
      seconds in forwards and in store writes) is printed and written to
      ``<out>/train_targets.json``.

``--stage student`` (``stage_student``, §3.2.2-3.3 and §3.5):
  (a) the same target generation, one worker, over the student's
      unlabeled batches (random features from the seed);
  (b) ``Trainer`` with ``--trainer gtc`` (``GTC(GTCConfig(tau=2e-4,
      n_workers=1))``, the ``gtc_compress`` kernel on every gradient
      leaf) or ``--trainer bmuf`` (``BMUFVmap(BMUFConfig(n_workers=4,
      block_steps=2))``, tau*W = 8 microbatches an update) fits
      ``scheduled_source`` over ``distill_shard_source`` sub-epochs
      (``pin_wave=True`` on the verified store) interleaved with labeled
      CE passes on random labels (the ``sparse_ce`` kernel in the
      distill loss);
  (c) it prints the updates, frames/s of training and the first and
      last loss, and writes them to ``<out>/train_student.json``; the
      final params go to ``<out>/ckpt_student_<trainer>``.

``--stage smbr`` (``stage_smbr``, §3.4-3.5): the student from
``<out>/ckpt_student_<trainer>`` (else ``<out>/ckpt_baseline``)
sequence-trained on the labeled corpus for two epochs under
``GTCShardMap`` at W = ``--gtc-workers`` (2; each update one padded
full-sequence batch per worker, the ``gtc_compress`` kernel on every
leaf of every worker, the int8 wire, no clipping); 1 runs the
single-process ``GTC``.  Final params in ``<out>/ckpt_smbr``; the
results carry the reference's keys (expected frame accuracy first and
last, ``val_fer`` against the baseline's).

The training stages checkpoint their TrainState every ``CKPT_EVERY`` (4)
updates into ``<out>/ckpt_<stage>/state`` and resume from it when
re-invoked; a stage that runs to its end clears it.  ``--prefetch N``
stages batches N ahead from pinned host memory on a side CUDA stream
(``pipeline.PrefetchingSource``; 0: the synchronous feed).

Runs on the card by default; ``--device cpu`` runs the plain PyTorch
path on the host.  ``--full`` is the published width (5x768 student and
teacher, 3,183 senones; the corpus at 64 mels stacked 3 to 192 features;
targets over 12 batches of 16 x 512 frames, the student on batches of
16 x 64); without it the reduced config at small batches.

  PYTHONPATH=src python -m repro_torch.launch.train --stage baseline --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --stage teacher --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --stage targets --full --workers 3
  PYTHONPATH=src python -m repro_torch.launch.train --stage student --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --stage student --trainer bmuf --full
  PYTHONPATH=src python -m repro_torch.launch.train --stage smbr --full

``--stage all`` raises, naming the ROADMAP step that brings it.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointStore
from repro_torch.configs import get_arch, reduced
from repro_torch.core.scheduled import ScheduleConfig
from repro_torch.core.teacher import TeacherRunner, make_teacher_config
from repro_torch.data import CorpusLoader, FeatureConfig, SynthConfig
from repro_torch.data.loader import full_seq_batches_of
from repro_torch.distributed.bmuf import BMUFConfig
from repro_torch.distributed.gtc import GTCConfig
from repro_torch.kernels._dispatch import resolve_device
from repro_torch.launch.steps import _tensor, make_loss_fn, model_forward
from repro_torch.models import LstmAM, build_model
from repro_torch.pipeline import WorkLedger, generate_sharded
from repro_torch.seqtrain import build_denominator_graph, make_smbr_loss_fn
from repro_torch.seqtrain.smbr import frame_error_rate
from repro_torch.store import (LogitStoreV2, full_bytes_per_frame,
                               storage_bytes_per_frame)
from repro_torch.train import data as train_data
from repro_torch.train import (GTC, BMUFVmap, GTCShardMap, ListSink, Local,
                               TrainBatch, Trainer, TrainState, chain,
                               distill_shard_source, epoch_source,
                               scheduled_source)

TOPK = 20
GTC_TAU = 2e-4
# PipelineConfig's student schedule, cut to two sub-epochs
SCHEDULE = ScheduleConfig(n_sub_epochs=2, sub_epoch_hours=1.0,
                          labeled_every=1, chunked_until=3, lr0=5e-2,
                          labeled_lr_boost=1.5)
# (rows per batch, frames per row, unlabeled batches per sub-epoch,
#  labeled batches per pass), by trainer: BMUF's phases are whole blocks
# of tau*W = 8 microbatches, so no microbatch is dropped
SIZES = {"gtc": {"full": (16, 64, 4, 2), "reduced": (4, 16, 4, 2)},
         "bmuf": {"full": (16, 64, 16, 8), "reduced": (4, 16, 8, 8)}}
# PipelineConfig's BMUF student: W = 4 lanes, tau = 2 local steps a block
BMUF = BMUFConfig(n_workers=4, block_steps=2)
# the training stages' TrainState checkpoint cadence, in updates (a stage
# here takes 6-18 updates; PipelineConfig's 20 would never checkpoint),
# and the prefetching feed's depth (PipelineConfig's)
CKPT_EVERY = 4
PREFETCH = 2
# --stage baseline: PipelineConfig's lr; the corpus and its cut
BASELINE_LR = 5e-2
BASELINE = {
    # the published widths: 64 mels x stack 3 = 192 features, 3,183
    # senones, SynthConfig's other defaults; batch 16, chunk_len 64;
    # 32 labeled utterances (3 chunked batches an epoch, 4 full-sequence
    # batches of 8), 2 chunked epochs + the fine-tune = 10 updates
    "full": dict(n_labeled=32, epochs=2, batch=16, chunk_len=64,
                 n_mels=64, synth={}),
    # PipelineConfig's corpus scale at the reduced widths (16 mels x 3 =
    # 48 features, 97 senones)
    "reduced": dict(n_labeled=8, epochs=2, batch=4, chunk_len=16,
                    n_mels=16, synth=dict(n_speakers=16, mean_utt_sec=1.2)),
}
# the held-out utterances of the validation FER: PipelineConfig's ids
# (100_000, n_val = 16); the FER reads their first full-sequence batch
VAL = (100_000, 16)
# --stage teacher / smbr: PipelineConfig's sMBR scale, kappa, lr, epochs
# and GTC workers
SMBR_KAPPA = 0.3
SMBR_LR = 5e-3
SMBR_EPOCHS = 2
GTC_WORKERS = 2
# --stage targets: (batches, rows per batch, frames per row); row lengths
# are drawn from [frames / 4, frames]
TARGET_SIZES = {"full": (12, 16, 512), "reduced": (3, 4, 16)}

NOT_PORTED = {
    "all": "ROADMAP Queue 1, step 7: the pipeline end to end",
}


@dataclass
class StudentRun:
    """What one student stage leaves behind: the printed results, the
    final TrainState, the loss functions and the data it trained on."""
    results: Dict
    state: TrainState
    loss_fns: Dict
    unlabeled: List[dict]
    store: LogitStoreV2


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_batches(cfg, *, rows: int, frames: int, n_unlabeled: int,
                 n_labeled: int, seed: int):
    """Random features (and, for the labeled set, random senone labels)
    from ``seed``.  Labeled batches carry ``n_feature_offsets - 1`` extra
    frames so each labeled pass can take its rotated window."""
    rng = np.random.default_rng(seed)
    f = cfg.feat_dim
    mask = np.ones((rows, frames), np.float32)
    unl = [{"feats": rng.normal(size=(rows, frames, f)).astype(np.float32),
            "mask": mask} for _ in range(n_unlabeled)]
    extra = SCHEDULE.n_feature_offsets - 1
    lab = [{"feats": rng.normal(size=(rows, frames + extra, f))
            .astype(np.float32),
            "labels": rng.integers(0, cfg.n_senones, (rows, frames))
            .astype(np.int32), "mask": mask} for _ in range(n_labeled)]
    return unl, lab


def make_target_batches(cfg, *, n: int, rows: int, frames: int,
                        seed: int) -> List[dict]:
    """``n`` ragged unlabeled batches from ``seed``: each row's length is
    drawn from [frames / 4, frames]; past it the features are zero and
    the mask is 0 (the biLSTM's ``lens`` and the store's per-row lens
    both come from the mask)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        lens = rng.integers(frames // 4, frames + 1, rows)
        mask = (np.arange(frames)[None, :] < lens[:, None]).astype(
            np.float32)
        feats = rng.normal(size=(rows, frames, cfg.feat_dim)).astype(
            np.float32) * mask[..., None]
        out.append({"feats": feats, "mask": mask})
    return out


def _teacher_cfg(full: bool):
    if full:
        return make_teacher_config(get_arch("lstm-am-7khr"))
    return reduced(get_arch("lstm-am-teacher"))


def _engine_from_ckpt(cfg, ckpt_dir: str, topk: int, device
                      ) -> TeacherRunner:
    """A worker's engine: the teacher rebuilt from its checkpoint."""
    like = LstmAM(cfg, device="meta", generator=None).state_dict()
    params, _ = CheckpointStore(ckpt_dir).load(like)
    return TeacherRunner(cfg, params, k=topk, device=device)


def teacher_checkpoint(teacher_cfg, out: str, seed: int) -> str:
    """``<out>/ckpt_teacher``: the trained teacher when ``--stage
    teacher`` left one there, else a random-init one (``seed + 1``)
    written now, as ``--stage targets`` needs a teacher either way.
    Returns which (the checkpoint's ``teacher`` meta)."""
    store = CheckpointStore(os.path.join(out, "ckpt_teacher"))
    if store.latest() is None:
        teacher = build_model(teacher_cfg, device="cpu",
                              generator=torch.Generator().manual_seed(
                                  seed + 1))
        store.save(0, teacher.state_dict(),
                   meta={"teacher": f"random init, seed {seed + 1}"})
    return (store.load_meta(store.latest()) or {}).get("teacher",
                                                       "checkpoint")


def generate_targets(teacher_cfg, batches: List[dict], *, device, seed: int,
                     workers: int, out: str, reuse: bool = False) -> Dict:
    """The teacher of ``teacher_checkpoint`` (trained, or random-init
    from ``seed + 1``), then its top-k of ``batches`` through
    ``generate_sharded`` over ``workers`` ledgered workers into
    ``<out>/logit_store``, verified.  Returns the reference's
    ``stage_targets`` report plus which teacher ran and the pass's
    seconds and frames/s.  ``reuse`` keeps a completed pass already in
    ``out`` (its ledger all done; verified, nothing forwarded) instead of
    superseding it: a resumed training stage reads the wave its
    checkpoint was trained on."""
    device = resolve_device(device)
    ckpt_dir = os.path.join(out, "ckpt_teacher")
    ledger_path = os.path.join(out, "gen_ledger.json")
    store = LogitStoreV2(os.path.join(out, "logit_store"), k=TOPK,
                         vocab=teacher_cfg.n_senones)
    teacher = teacher_checkpoint(teacher_cfg, out, seed)
    if reuse and WorkLedger.peek_all_done(ledger_path):
        t0 = time.perf_counter()
        rep = {"n_shards": len(batches), "n_written": 0,
               "n_workers": workers,
               "wave": WorkLedger.attach(ledger_path).wave, "resumed": True,
               "frames_written": 0, "forward_s": 0.0, "write_s": 0.0}
    else:
        t0 = time.perf_counter()
        rep = generate_sharded(
            lambda w: _engine_from_ckpt(teacher_cfg, ckpt_dir, TOPK, device),
            batches, store, n_workers=workers, ledger_path=ledger_path)
    _sync(device)
    gen_s = time.perf_counter() - t0
    store.verify()
    meta = store.stats()
    full = meta.n_frames * full_bytes_per_frame(teacher_cfg.n_senones)
    packed = meta.n_frames * storage_bytes_per_frame(TOPK)
    return {"n_shards": rep["n_shards"], "n_frames": meta.n_frames,
            "n_workers": rep["n_workers"], "wave": rep["wave"],
            "resumed": rep["resumed"],
            "storage_compression_x": round(full / packed, 1),
            "teacher_ckpt": teacher,
            "device": str(device), "n_written": rep["n_written"],
            "frames_written": rep["frames_written"], "gen_s": gen_s,
            "frames_per_s": rep["frames_written"] / gen_s,
            "forward_s": rep["forward_s"], "write_s": rep["write_s"]}


def stage_targets(*, full: bool, device, seed: int = 0, workers: int = 3,
                  out: str = "experiments/train_torch",
                  log=print) -> Dict:
    """Sharded target generation (the reference's
    ``SSLPipeline.stage_targets``, in-process) over ``make_target_batches``
    of ``TARGET_SIZES``; writes ``<out>/train_targets.json``."""
    cfg = _teacher_cfg(full)
    n, rows, frames = TARGET_SIZES["full" if full else "reduced"]
    batches = make_target_batches(cfg, n=n, rows=rows, frames=frames,
                                  seed=seed)
    rep = generate_targets(cfg, batches, device=device, seed=seed,
                           workers=workers, out=out)
    rep["teacher"] = cfg.name
    log(f"[train] {cfg.name} targets ({rep['teacher_ckpt']}) on "
        f"{rep['device']}: "
        f"{rep['n_written']} of {n} batches of {rows}x{frames} "
        f"({rep['frames_written']} frames) by {workers} workers in "
        f"{rep['gen_s']:.2f} s = {rep['frames_per_s']:.1f} frames/s "
        f"(forwards {rep['forward_s']:.2f} s, store writes "
        f"{rep['write_s']:.3f} s); wave {rep['wave']}, resumed "
        f"{rep['resumed']}; {rep['n_shards']} shards verified, "
        f"{rep['storage_compression_x']}x smaller than full logits")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "train_targets.json"), "w") as f:
        json.dump(rep, f, indent=1)
    return rep


def _state_store(out: str, stage: str) -> CheckpointStore:
    """A training stage's resume checkpoints: ``<out>/ckpt_<stage>/state``."""
    return CheckpointStore(os.path.join(out, f"ckpt_{stage}", "state"))


def stage_student(*, full: bool, device, seed: int = 0, steps: int = 0,
                  trainer: str = "gtc", ckpt_every: int = CKPT_EVERY,
                  prefetch: int = PREFETCH,
                  out: str = "experiments/train_torch",
                  log=print) -> StudentRun:
    """Teacher targets -> scheduled distillation of the student under
    GTC or BMUF.  ``steps`` > 0 stops after that many updates (0: the
    whole schedule); ``ckpt_every`` > 0 checkpoints the TrainState that
    often into ``<out>/ckpt_student_<trainer>/state``, from which a
    re-invocation resumes (0: never); ``prefetch`` is the feed's depth
    (0: synchronous)."""
    if trainer not in SIZES:
        raise ValueError(f"unknown trainer {trainer!r}")
    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    student_cfg = get_arch("lstm-am-7khr")
    if not full:
        student_cfg = reduced(student_cfg)
    teacher_cfg = _teacher_cfg(full)
    rows, frames, per_sub, per_pass = \
        SIZES[trainer]["full" if full else "reduced"]
    unl, lab = make_batches(student_cfg, rows=rows, frames=frames,
                            n_unlabeled=SCHEDULE.n_sub_epochs * per_sub,
                            n_labeled=per_pass, seed=seed)

    # (a) teacher targets into the v2 store, one worker; the workers=1
    # consumer's contract is the manifest: verify() checksums every shard.
    # A resumed stage keeps the completed pass its checkpoint trained on
    ckpt = _state_store(out, f"student_{trainer}")
    resumed_at = ckpt.latest()
    gen = generate_targets(teacher_cfg, unl, device=device, seed=seed,
                           workers=1, out=out, reuse=resumed_at is not None)
    store = LogitStoreV2(os.path.join(out, "logit_store"), k=TOPK,
                         vocab=teacher_cfg.n_senones)
    store.verify()

    # (b) scheduled learning under the trainer
    student = build_model(student_cfg, device=device,
                          generator=torch.Generator().manual_seed(seed))
    loss_fns = {"distill_topk": make_loss_fn(student, student_cfg,
                                             "distill_topk"),
                "ce": make_loss_fn(student, student_cfg, "ce")}
    strategy = (BMUFVmap(BMUF) if trainer == "bmuf"
                else GTC(GTCConfig(tau=GTC_TAU, n_workers=1)))
    sink = ListSink()
    tr = Trainer(strategy, loss_fns, checkpoint=ckpt,
                 ckpt_every=ckpt_every, metrics=sink, prefetch=prefetch)
    state = tr.init_state(dict(student.state_dict()), seed=seed)

    def unlabeled(phase):
        lo = (phase.sub_epoch - 1) * per_sub
        # pin_wave: each sub-epoch snapshots its shards' manifest entries
        # at start, so a regeneration landing mid-sub-epoch cannot mix
        # targets into this pass
        return distill_shard_source(unl, store, lo, lo + per_sub, phase.lr,
                                    pin_wave=True)

    def labeled(phase):
        o = max(phase.feature_offset, 0)
        return (TrainBatch({"feats": b["feats"][:, o:o + frames],
                            "labels": b["labels"], "mask": b["mask"]},
                           phase.lr, "ce") for b in lab)

    train_data.SHARD_COPIES = 0
    t0 = time.perf_counter()
    state = tr.fit(state, scheduled_source(SCHEDULE, unlabeled=unlabeled,
                                           labeled=labeled),
                   max_updates=steps or None)
    _sync(device)
    train_s = time.perf_counter() - t0
    tr.finalize(state)
    CheckpointStore(os.path.join(out, f"ckpt_student_{trainer}")).save(
        0, state.params)

    # (c) results
    losses = sink.values("loss")
    n_run = len(sink.records)
    n_frames = n_run * strategy.microbatches * rows * frames
    results = {
        "device": str(device), "full": full, "trainer": trainer,
        "student": student_cfg.name, "teacher": teacher_cfg.name,
        "batch": [rows, frames], "microbatches": strategy.microbatches,
        "shards": gen["n_shards"], "targets_s": gen["gen_s"],
        "targets_wave": gen["wave"], "targets_written": gen["n_written"],
        "shard_copies": train_data.SHARD_COPIES, "updates": state.step,
        "resumed_at": resumed_at, "updates_run": n_run,
        "updates_by_loss": {t: sum(1 for _, tg, _ in sink.records
                                   if tg == t) for t in loss_fns},
        "prefetch": prefetch, "train_s": train_s, "train_frames": n_frames,
        "frames_per_s": n_frames / train_s,
        "loss_first": losses[0], "loss_last": losses[-1],
    }
    if trainer == "gtc":
        results["gtc_density"] = sink.values("gtc_density")
    log(f"[train] {student_cfg.name} student stage ({trainer}) on {device}: "
        f"{len(unl)} teacher batches -> {results['shards']} shards "
        f"(wave {gen['wave']}) in {gen['gen_s']:.2f} s; {n_run} updates "
        f"({results['updates_by_loss']}) of {strategy.microbatches} x "
        f"{rows}x{frames} frames in {train_s:.2f} s = "
        f"{results['frames_per_s']:.1f} frames/s"
        + (f", resumed at update {resumed_at}" if resumed_at else ""))
    log(f"[train] loss first {losses[0]:.4f} last {losses[-1]:.4f}"
        + ("; gtc_density first {:.4f} last {:.4f}".format(
            results["gtc_density"][0], results["gtc_density"][-1])
           if trainer == "gtc" else ""))
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "train_student.json"), "w") as f:
        json.dump(results, f, indent=1)
    return StudentRun(results, state, loss_fns, unl, store)


@dataclass
class BaselineRun:
    """What the baseline stage leaves behind: the printed results, the
    final TrainState, the CE loss function, the corpus loader and the
    first (chunked) and last (full-sequence) batches it trained on."""
    results: Dict
    state: TrainState
    loss_fn: object
    loader: CorpusLoader
    first_batch: dict
    last_batch: dict


def baseline_corpus(cfg, *, full: bool, seed: int) -> CorpusLoader:
    """The reference's synthetic corpus at ``cfg``'s widths: ``FeatureConfig``
    with ``feat_dim / 3`` mels, ``SynthConfig`` with ``cfg.n_senones``,
    the global MVN estimated over the first labeled utterances (as
    ``SSLPipeline``, look-ahead 0)."""
    b = BASELINE["full" if full else "reduced"]
    if b["n_mels"] * 3 != cfg.feat_dim:
        raise ValueError(f"{cfg.name}: feat_dim {cfg.feat_dim} is not "
                         f"{b['n_mels']} mels x 3")
    loader = CorpusLoader(
        synth=SynthConfig(n_senones=cfg.n_senones, seed=seed, **b["synth"]),
        feat=FeatureConfig(n_mels=b["n_mels"]), lookahead=0)
    loader.estimate_mvn(min(24, b["n_labeled"]))
    return loader


def baseline_source(loader: CorpusLoader, *, full: bool, lr: float,
                    seed0: int = 0):
    """The reference's ``_ce_source`` over the labeled ids [0, n):
    chunked-BPTT epochs with rotating feature offsets, then one
    full-sequence fine-tune epoch at ``lr * 0.3``."""
    b = BASELINE["full" if full else "reduced"]
    n = b["n_labeled"]
    return chain(
        epoch_source(
            lambda ep: list(loader.chunked_batches(
                0, n, batch_size=b["batch"], chunk_len=b["chunk_len"],
                offset=ep % 3, seed=seed0 + ep)),
            b["epochs"], lr, "ce"),
        epoch_source(
            lambda ep: list(loader.full_seq_batches(
                0, n, batch_size=max(2, b["batch"] // 2))),
            1, lr * 0.3, "ce"))


class _Counted:
    """A training source that counts, for each batch it yields, its real
    frames (the mask's sum), keeps the first and the latest batch, and
    adds up the seconds spent inside the source (synthesis,
    featurization, batching; on the feed's thread when prefetching)."""

    def __init__(self, source):
        self.source = iter(source)
        self.frames: List[float] = []
        self.seen: List[dict] = []
        self.source_s = 0.0

    def __iter__(self):
        while True:
            t = time.perf_counter()
            tb = next(self.source, None)
            self.source_s += time.perf_counter() - t
            if tb is None:
                return
            self.frames.append(float(np.asarray(tb.data["mask"]).sum()))
            self.seen[1:] = [tb.data]             # the first and the latest
            yield tb

    def real(self, n_batches: int) -> float:
        """Real frames of the last ``n_batches`` (the ones trained on
        after a resume's skipped prefix)."""
        return sum(self.frames[len(self.frames) - n_batches:])


def val_batch(loader: CorpusLoader, *, full: bool) -> dict:
    """The first full-sequence batch of the held-out utterances ``VAL``
    (the reference's ``SSLPipeline.val_batch``)."""
    b = BASELINE["full" if full else "reduced"]
    return next(loader.full_seq_batches(*VAL, batch_size=max(2, b["batch"]
                                                               // 2)))


def val_fer(model, cfg, params, batch: dict) -> float:
    """Frame error rate of ``params`` on ``batch`` (the reference's
    ``SSLPipeline.fer``: the forward without lens, argmax per frame,
    masked)."""
    w = model.unembed_matrix(params)
    with torch.no_grad():
        h, _ = model_forward(model, cfg, params,
                             {"feats": _tensor(batch["feats"], w.device,
                                               torch.float32)})
        return float(frame_error_rate((h @ w).float(), batch["labels"],
                                      batch["mask"]))


def _pad_time(batch: dict, t: int) -> dict:
    """Zero-pad every (B, T, ...) leaf of a full-seq batch to T = t
    (mask rows stay 0 over the padding, so losses are unchanged)."""
    out = {}
    for k, v in batch.items():
        if getattr(v, "ndim", 0) >= 2 and v.shape[1] < t:
            pad = [(0, 0)] * v.ndim
            pad[1] = (0, t - v.shape[1])
            out[k] = np.pad(v, pad)
        else:
            out[k] = v
    return out


def labeled_full_seq(pairs, *, full: bool, uniform_len: bool = False
                     ) -> List[dict]:
    """The labeled utterances' full-sequence batches, cut from ``pairs``
    (the loader's ``featurized`` list) as ``CorpusLoader.full_seq_batches``
    cuts them.  ``uniform_len`` pads every batch to the longest: a
    multi-worker strategy groups shape-mates, so ragged batches would
    drop partial groups at every length boundary."""
    b = BASELINE["full" if full else "reduced"]
    out = list(full_seq_batches_of(pairs, batch_size=max(2, b["batch"] // 2)))
    if uniform_len and out:
        t = max(x["feats"].shape[1] for x in out)
        out = [_pad_time(x, t) for x in out]
    return out


def denominator_graph(pairs, n_senones: int):
    """The sMBR denominator graph from the labeled alignments (the
    reference's ``SSLPipeline._graph``)."""
    return build_denominator_graph([lab for _, lab, _ in pairs], n_senones)


def smbr_source(batches: List[dict], n_epochs: int):
    """``n_epochs`` passes over ``batches`` at ``SMBR_LR`` under the
    "smbr" loss."""
    return epoch_source(lambda ep: batches, n_epochs, SMBR_LR, "smbr")


def stage_baseline(*, full: bool, device, seed: int = 0,
                   ckpt_every: int = CKPT_EVERY, prefetch: int = PREFETCH,
                   out: str = "experiments/train_torch",
                   log=print) -> BaselineRun:
    """CE training of the student on the synthetic corpus under
    ``Local()`` (the reference's ``SSLPipeline.stage_baseline``); final
    params into ``<out>/ckpt_baseline``, results into
    ``<out>/train_baseline.json``."""
    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_arch("lstm-am-7khr")
    if not full:
        cfg = reduced(cfg)
    t0 = time.perf_counter()
    loader = baseline_corpus(cfg, full=full, seed=seed)
    mvn_s = time.perf_counter() - t0
    model = build_model(cfg, device=device,
                        generator=torch.Generator().manual_seed(seed))
    loss_fn = make_loss_fn(model, cfg, "ce")
    sink = ListSink()
    ckpt = _state_store(out, "baseline")
    tr = Trainer(Local(), {"ce": loss_fn}, checkpoint=ckpt,
                 ckpt_every=ckpt_every, metrics=sink, prefetch=prefetch)
    state = tr.init_state(dict(model.state_dict()), seed=seed)
    resumed_at = ckpt.latest()
    source = _Counted(baseline_source(loader, full=full, lr=BASELINE_LR))
    t0 = time.perf_counter()
    state = tr.fit(state, source)
    _sync(device)
    train_s = time.perf_counter() - t0
    tr.finalize(state)
    CheckpointStore(os.path.join(out, "ckpt_baseline")).save(0, state.params)
    losses = sink.values("loss")
    n_run = len(sink.records)
    real = source.real(n_run)
    results = {
        "device": str(device), "full": full, "student": cfg.name,
        "n_labeled": BASELINE["full" if full else "reduced"]["n_labeled"],
        "batches": len(source.frames), "updates": state.step,
        "resumed_at": resumed_at, "updates_run": n_run,
        "prefetch": prefetch, "mvn_s": mvn_s, "source_s": source.source_s,
        "train_s": train_s, "train_frames": real,
        "frames_per_s": real / train_s,
        "loss_first": losses[0] if losses else None,
        "loss_last": losses[-1] if losses else None,
        "val_fer": val_fer(model, cfg, state.params,
                           val_batch(loader, full=full)),
    }
    log(f"[train] {cfg.name} baseline on {device}: {n_run} CE updates "
        f"over {results['n_labeled']} synthetic utterances ({real:.0f} "
        f"real frames) in {train_s:.2f} s = {results['frames_per_s']:.1f} "
        f"frames/s ({source.source_s:.2f} s in the corpus source; corpus "
        f"MVN {mvn_s:.2f} s before)"
        + (f", resumed at update {resumed_at}" if resumed_at else ""))
    if losses:
        log(f"[train] loss first {losses[0]:.4f} last {losses[-1]:.4f}; "
            f"val FER {results['val_fer']:.4f}")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "train_baseline.json"), "w") as f:
        json.dump(results, f, indent=1)
    return BaselineRun(results, state, loss_fn, loader, source.seen[0],
                       source.seen[-1])


@dataclass
class SeqRun:
    """What a sequence-training stage leaves behind: the printed
    results, the final TrainState, the sMBR loss function, the
    denominator graph and the full-sequence batches."""
    results: Dict
    state: TrainState
    loss_fn: object
    graph: object
    batches: List[dict]


def stage_teacher(*, full: bool, device, seed: int = 0,
                  ckpt_every: int = CKPT_EVERY, prefetch: int = PREFETCH,
                  out: str = "experiments/train_torch",
                  log=print) -> SeqRun:
    """The biLSTM teacher (the reference's ``SSLPipeline.stage_teacher``):
    CE on the synthetic corpus under ``Local()`` (the baseline's source,
    chunk shuffle seeded from 100), then one epoch of sMBR fine-tune over
    the full-sequence labeled batches under ``Local(clip=0.0)``.  Final
    params into ``<out>/ckpt_teacher``, results into
    ``<out>/train_teacher.json``."""
    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _teacher_cfg(full)
    loader = baseline_corpus(cfg, full=full, seed=seed)
    model = build_model(cfg, device=device,
                        generator=torch.Generator().manual_seed(seed + 1))
    sink = ListSink()
    ce_ckpt = _state_store(out, "teacher")
    tr = Trainer(Local(), {"ce": make_loss_fn(model, cfg, "ce")},
                 checkpoint=ce_ckpt, ckpt_every=ckpt_every, metrics=sink,
                 prefetch=prefetch)
    state = tr.init_state(dict(model.state_dict()), seed=seed + 1)
    ce_resumed = ce_ckpt.latest()
    ce_src = _Counted(baseline_source(loader, full=full, lr=BASELINE_LR,
                                      seed0=100))
    t0 = time.perf_counter()
    state = tr.fit(state, ce_src)
    _sync(device)
    ce_s = time.perf_counter() - t0

    # the sMBR fine-tune (the paper's "with sMBR teacher" arm); no clip:
    # sMBR grads are already bounded by the posteriors
    pairs = loader.featurized(0, BASELINE["full" if full else "reduced"]
                              ["n_labeled"])
    graph = denominator_graph(pairs, cfg.n_senones)
    batches = labeled_full_seq(pairs, full=full)
    loss_fn = make_smbr_loss_fn(model, cfg, graph, kappa=SMBR_KAPPA)
    smbr_sink = ListSink()
    smbr_ckpt = _state_store(out, "teacher_smbr")
    smbr_tr = Trainer(Local(clip=0.0), {"smbr": loss_fn},
                      checkpoint=smbr_ckpt, ckpt_every=ckpt_every,
                      metrics=smbr_sink, prefetch=prefetch)
    sstate = smbr_tr.init_state(state.params, seed=seed + 1)
    smbr_resumed = smbr_ckpt.latest()
    smbr_src = _Counted(smbr_source(batches, 1))
    t0 = time.perf_counter()
    sstate = smbr_tr.fit(sstate, smbr_src)
    _sync(device)
    smbr_s = time.perf_counter() - t0
    # retire resume state only once the whole stage is done: a kill
    # during the sMBR sub-fit must resume (not retrain) the CE part
    tr.finalize(state)
    smbr_tr.finalize(sstate)
    CheckpointStore(os.path.join(out, "ckpt_teacher")).save(
        0, sstate.params, meta={"teacher": "trained (--stage teacher)"})

    ce_run, smbr_run = len(sink.records), len(smbr_sink.records)
    ce_real, smbr_real = ce_src.real(ce_run), smbr_src.real(smbr_run)
    results = {
        "device": str(device), "full": full, "teacher": cfg.name,
        "loss_last": sink.last("loss"),
        "val_fer": val_fer(model, cfg, sstate.params,
                           val_batch(loader, full=full)),
        "smbr_eacc": smbr_sink.last("expected_frame_acc"),
        "smbr_log_z": smbr_sink.last("log_z"),
        "ce_updates": state.step, "ce_updates_run": ce_run,
        "ce_resumed_at": ce_resumed, "ce_train_s": ce_s,
        "ce_frames": ce_real, "ce_frames_per_s": ce_real / ce_s,
        "ce_source_s": ce_src.source_s,
        "smbr_updates": sstate.step, "smbr_updates_run": smbr_run,
        "smbr_resumed_at": smbr_resumed, "smbr_train_s": smbr_s,
        "smbr_frames": smbr_real, "smbr_frames_per_s": smbr_real / smbr_s,
        "smbr_batch": list(batches[0]["feats"].shape[:2]),
    }
    eacc = results["smbr_eacc"]
    log(f"[train] {cfg.name} teacher on {device}: {ce_run} CE updates "
        f"({ce_real:.0f} real frames) in {ce_s:.2f} s = "
        f"{results['ce_frames_per_s']:.1f} frames/s, then {smbr_run} sMBR "
        f"updates of {len(batches[0]['feats'])} full-sequence rows "
        f"({smbr_real:.0f} real frames) in {smbr_s:.2f} s = "
        f"{results['smbr_frames_per_s']:.1f} frames/s"
        + (f"; sMBR eacc {eacc:.4g}, log Z {results['smbr_log_z']:.2f}"
           if eacc is not None else "")
        + f"; val FER {results['val_fer']:.4f}"
        + (f"; resumed at CE update {ce_resumed}" if ce_resumed else "")
        + (f", sMBR update {smbr_resumed}" if smbr_resumed else ""))
    log("[train] " + json.dumps({k: results[k] for k in
                                 ("loss_last", "val_fer", "smbr_eacc")}))
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "train_teacher.json"), "w") as f:
        json.dump(results, f, indent=1)
    return SeqRun(results, sstate, loss_fn, graph, batches)


def _load_params(cfg, ckpt_dir: str, device):
    """The state dict saved at ``ckpt_dir`` on ``device``, or None."""
    store = CheckpointStore(ckpt_dir)
    if store.latest() is None:
        return None
    like = LstmAM(cfg, device="meta", generator=None).state_dict()
    params, _ = store.load(like)
    return {n: p.to(device) for n, p in params.items()}


def stage_smbr(*, full: bool, device, seed: int = 0, trainer: str = "gtc",
               gtc_workers: int = GTC_WORKERS,
               ckpt_every: int = CKPT_EVERY, prefetch: int = PREFETCH,
               out: str = "experiments/train_torch",
               log=print) -> SeqRun:
    """Sequence training of the student on the labeled corpus (the
    reference's ``SSLPipeline.stage_smbr``): from
    ``<out>/ckpt_student_<trainer>``, else ``<out>/ckpt_baseline``, two
    sMBR epochs under ``GTCShardMap`` at W = ``gtc_workers`` (each
    update one padded full-sequence batch per worker, the int8 wire, no
    clip), or the single-process ``GTC`` at 1.  Final params into
    ``<out>/ckpt_smbr``, results into ``<out>/train_smbr.json``."""
    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_arch("lstm-am-7khr")
    if not full:
        cfg = reduced(cfg)
    base = _load_params(cfg, os.path.join(out, "ckpt_baseline"), device)
    if base is None:
        raise FileNotFoundError(f"no baseline under {out}: run --stage "
                                "baseline first")
    start = f"student_{trainer}"
    params = _load_params(cfg, os.path.join(out, f"ckpt_{start}"), device)
    if params is None:
        start, params = "baseline", base
    loader = baseline_corpus(cfg, full=full, seed=seed)
    pairs = loader.featurized(0, BASELINE["full" if full else "reduced"]
                              ["n_labeled"])
    graph = denominator_graph(pairs, cfg.n_senones)
    batches = labeled_full_seq(pairs, full=full,
                               uniform_len=gtc_workers > 1)
    model = build_model(cfg, device=device, params=params)
    loss_fn = make_smbr_loss_fn(model, cfg, graph, kappa=SMBR_KAPPA)
    if gtc_workers > 1:
        strategy = GTCShardMap(GTCConfig(tau=GTC_TAU, n_workers=gtc_workers),
                               clip=0.0)
    else:
        strategy = GTC(GTCConfig(tau=GTC_TAU, n_workers=1), clip=0.0)
    sink = ListSink()
    ckpt = _state_store(out, "smbr")
    tr = Trainer(strategy, {"smbr": loss_fn}, checkpoint=ckpt,
                 ckpt_every=ckpt_every, metrics=sink, prefetch=prefetch)
    state = tr.init_state(params, seed=seed)
    resumed_at = ckpt.latest()
    source = _Counted(smbr_source(batches, SMBR_EPOCHS))
    t0 = time.perf_counter()
    state = tr.fit(state, source)
    _sync(device)
    train_s = time.perf_counter() - t0
    tr.finalize(state)
    CheckpointStore(os.path.join(out, "ckpt_smbr")).save(0, state.params)

    n_run = len(sink.records)
    real = source.real(n_run * strategy.microbatches)
    vb = val_batch(loader, full=full)
    fer = val_fer(model, cfg, state.params, vb)
    base_fer = val_fer(model, cfg, base, vb)
    results = {
        "eacc_first": sink.first("expected_frame_acc"),
        "eacc_last": sink.last("expected_frame_acc"),
        "val_fer": fer, "baseline_fer": base_fer,
        "rel_fer_reduction_pct":
            round(100 * (base_fer - fer) / max(base_fer, 1e-9), 2),
        "device": str(device), "full": full, "student": cfg.name,
        "start": start, "gtc_workers": gtc_workers,
        "microbatches": strategy.microbatches,
        "batch": list(batches[0]["feats"].shape[:2]),
        "updates": state.step, "resumed_at": resumed_at,
        "updates_run": n_run, "prefetch": prefetch,
        "source_s": source.source_s, "train_s": train_s,
        "train_frames": real, "frames_per_s": real / train_s,
        "log_z": sink.values("log_z"),
        "gtc_density": sink.values("gtc_density"),
    }
    log(f"[train] {cfg.name} sMBR on {device} from {start}: {n_run} updates "
        f"of {strategy.microbatches} x {results['batch'][0]}x"
        f"{results['batch'][1]} frames (W = {gtc_workers}, {real:.0f} real "
        f"frames) in {train_s:.2f} s = {results['frames_per_s']:.1f} frames/s"
        + (f"; eacc {results['eacc_first']:.4g} -> "
           f"{results['eacc_last']:.4g}, gtc_density last "
           f"{results['gtc_density'][-1]:.4g}" if n_run else "")
        + f"; val FER {fer:.4f} (baseline {base_fer:.4f})"
        + (f", resumed at update {resumed_at}" if resumed_at else ""))
    log("[train] " + json.dumps({k: results[k] for k in
                                 ("eacc_first", "eacc_last", "val_fer",
                                  "baseline_fer", "rel_fer_reduction_pct")}))
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "train_smbr.json"), "w") as f:
        json.dump(results, f, indent=1)
    return SeqRun(results, state, loss_fn, graph, batches)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="lstm-am-7khr")
    ap.add_argument("--stage", default="student",
                    choices=["all", "baseline", "teacher", "targets",
                             "student", "smbr"])
    ap.add_argument("--trainer", default="gtc", choices=["gtc", "bmuf"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true",
                    help="the published width, without reduced()")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=0,
                    help="stop after this many updates (0: the whole "
                         "schedule, 12 GTC or 6 BMUF updates)")
    ap.add_argument("--prefetch", type=int, default=PREFETCH,
                    help="batches staged ahead on a side stream (0: the "
                         "synchronous feed)")
    ap.add_argument("--workers", type=int, default=3,
                    help="--stage targets: in-process generation workers")
    ap.add_argument("--gtc-workers", type=int, default=GTC_WORKERS,
                    help="--stage smbr: GTC workers (1: the "
                         "single-process GTC)")
    ap.add_argument("--out", default="experiments/train_torch")
    args = ap.parse_args(argv)
    if args.arch != "lstm-am-7khr":
        raise NotImplementedError(
            f"--arch {args.arch} is not ported yet: only the lstm-am-7khr "
            "stages are (ROADMAP Queue 1, step 10: token-LM side branch)")
    if args.stage in NOT_PORTED:
        raise NotImplementedError(f"--stage {args.stage} is not ported yet "
                                  f"({NOT_PORTED[args.stage]})")
    common = dict(full=args.full, device=args.device, seed=args.seed,
                  out=args.out)
    if args.stage == "targets":
        return stage_targets(workers=args.workers, **common)
    if args.stage == "baseline":
        return stage_baseline(prefetch=args.prefetch, **common).results
    if args.stage == "teacher":
        return stage_teacher(prefetch=args.prefetch, **common).results
    if args.stage == "smbr":
        return stage_smbr(trainer=args.trainer, gtc_workers=args.gtc_workers,
                          prefetch=args.prefetch, **common).results
    return stage_student(steps=args.steps, trainer=args.trainer,
                         prefetch=args.prefetch, **common).results


if __name__ == "__main__":
    main()
