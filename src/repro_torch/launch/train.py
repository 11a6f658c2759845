"""Trainer CLI: the paper's recipe on the card.

The twin of the reference's ``launch/train.py`` for ``--arch
lstm-am-7khr``.  Two routes:

**The pipeline** (the default; the reference's interface):
``--stage {all,baseline,teacher,targets,student,smbr}`` (default
``all``) runs ``core.ssl_pipeline.SSLPipeline(...).run(stage)`` at
``--scale tiny|small`` (``PipelineConfig.tiny()`` / ``.small()``, default
tiny) over the seeded synthetic corpus: baseline CE -> the biLSTM teacher
(CE, then sMBR) -> its top-k targets into ``<out>/logit_store`` (the
``topk_logits`` kernel) -> scheduled student training under ``--trainer
gtc|bmuf`` (the ``sparse_ce`` kernel in the distill loss, ``gtc_compress``
under GTC) -> the student's sMBR under ``GTCShardMap`` (``gtc_compress``).
``--gen-workers``, ``--gtc-workers`` and ``--prefetch`` override the
config's; the stage's results (the reference's keys) are printed and
written to ``<out>/train_<stage>.json``.  A killed stage resumes from
``<out>/ckpt_<stage>/state`` when re-invoked.

**``--full``**: one stage at the published widths (5x768 student and
teacher, 3,183 senones, k = 20), as ``chip_smoke.py``'s phases drive
them.  The corpus stages are the pipeline's own, at ``stage_config``:

``--stage baseline`` (``stage_baseline``, paper §2),
``--stage teacher`` (``stage_teacher``, §3.2) and ``--stage smbr``
(``stage_smbr``, §3.4-3.5, from ``<out>/ckpt_student_<trainer>`` else
``<out>/ckpt_baseline``, W = ``--gtc-workers``) run
``SSLPipeline.stage_<s>`` over 32 labeled utterances of the corpus at 64
mels x 3 = 192 features, and add the fit's counts and rates to the
pipeline's results.

The kernel-rate stages run on random data from ``--seed``:

``--stage targets`` (``stage_targets``, §3.2.2): the teacher of
``<out>/ckpt_teacher`` (a random-init one is written there when it holds
none) over ``--gen-workers`` in-process ledgered workers, each with its
own ``TeacherRunner``, through ``pipeline.generate_sharded`` over 12
ragged batches of 16 x 512 random features into
``LogitStoreV2(<out>/logit_store)`` (``<out>/gen_ledger.json``),
verified; the report adds which teacher ran, frames/s and the seconds in
forwards and in store writes.

``--stage student`` (``stage_student``, §3.2.2-3.3, §3.5): a random-init
student distilled from the teacher's targets of random features (one
worker), interleaved with labeled CE passes on random labels, under
``--trainer gtc`` (``GTC(tau=2e-4)``) or ``bmuf`` (``BMUFVmap``, W = 4
lanes, tau = 2: 8 microbatches an update); ``--steps N`` stops after N
updates.  Final params in ``<out>/ckpt_student_<trainer>``.

These checkpoint their TrainState every ``CKPT_EVERY`` (4) updates and
resume when re-invoked; ``--prefetch N`` (default 2) stages batches from
pinned host memory on a side CUDA stream.  The stage functions take
``full=False`` for reduced widths, which the tests call directly.
``--seed`` and ``--steps`` apply to ``--full`` only (without it they
raise); ``--full --stage all`` raises: the pipeline runs at ``--scale``.

Both routes run on the card by default; ``--device cpu`` runs the plain
PyTorch path on the host.  ``--gen-procs N`` runs target generation in N
OS processes (``runtime/workers.py``'s Supervisor; each worker rebuilds
the engine from the checkpoint on disk, on ``--device``), on both routes;
``--cluster`` raises, naming ROADMAP Queue 1, step 8b.

  PYTHONPATH=src python -m repro_torch.launch.train --stage all --scale tiny
  PYTHONPATH=src python -m repro_torch.launch.train --trainer bmuf --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --stage targets --full --gen-workers 3
  PYTHONPATH=src python -m repro_torch.launch.train --stage targets --full --gen-procs 3
  PYTHONPATH=src python -m repro_torch.launch.train --stage student --trainer bmuf --full
  PYTHONPATH=src python -m repro_torch.launch.train --stage smbr --full
"""
from __future__ import annotations

import argparse
import json
import os
import time
from dataclasses import dataclass, replace
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointStore
from repro_torch.configs import get_arch, reduced
from repro_torch.core.scheduled import ScheduleConfig
from repro_torch.core.ssl_pipeline import PipelineConfig, SSLPipeline, _sync
from repro_torch.core.teacher import make_teacher_config
from repro_torch.distributed.bmuf import BMUFConfig
from repro_torch.distributed.gtc import GTCConfig
from repro_torch.kernels._dispatch import resolve_device
from repro_torch.launch.steps import make_loss_fn
from repro_torch.models import build_model
from repro_torch.pipeline import WorkLedger, generate_sharded
from repro_torch.runtime.workers import engine_from_checkpoint
from repro_torch.store import (LogitStoreV2, full_bytes_per_frame,
                               storage_bytes_per_frame)
from repro_torch.train import data as train_data
from repro_torch.train import (GTC, BMUFVmap, ListSink, TrainBatch, Trainer,
                               TrainState, distill_shard_source,
                               scheduled_source)
from repro_torch.train.strategies import _ELASTIC

TOPK = 20
GTC_TAU = PipelineConfig.gtc_tau
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
# --stage targets: (batches, rows per batch, frames per row); row lengths
# are drawn from [frames / 4, frames]
TARGET_SIZES = {"full": (12, 16, 512), "reduced": (3, 4, 16)}


def stage_config(full: bool, **over) -> PipelineConfig:
    """The ``PipelineConfig`` the corpus stages (baseline, teacher, smbr)
    run at, PipelineConfig's lr, sMBR and GTC settings throughout:
    ``full``, the published widths (5x768, 3,183 senones, 64 mels x 3 =
    192 features, SynthConfig's speakers and utterance lengths), 32
    labeled utterances in batches of 16 x 64 frames (3 chunked batches
    an epoch, 4 full-sequence batches of 8), 2 chunked epochs + the
    fine-tune = 10 CE updates; else the reduced widths (1 x 128, 97
    senones, 16 mels) at PipelineConfig's corpus scale, 8 utterances in
    batches of 4 x 16.  ``over`` overrides fields."""
    if full:
        pc = PipelineConfig(n_labeled=32, n_speakers=200, n_senones=3183,
                            mean_utt_sec=2.0, n_mels=64, n_layers=5,
                            lstm_hidden=768, batch=16, chunk_len=64)
    else:
        pc = PipelineConfig(n_labeled=8, n_senones=97, n_layers=1,
                            lstm_hidden=128, batch=4, chunk_len=16)
    return replace(pc, **{"epochs_baseline": 2, "topk": TOPK,
                          "ckpt_every": CKPT_EVERY, **over})


@dataclass
class StudentRun:
    """What one student stage leaves behind: the printed results, the
    final TrainState, the loss functions and the data it trained on."""
    results: Dict
    state: TrainState
    loss_fns: Dict
    unlabeled: List[dict]
    store: LogitStoreV2


def _write(out: str, stage: str, results: Dict):
    """``results`` into ``<out>/train_<stage>.json``."""
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"train_{stage}.json"), "w") as f:
        json.dump(results, f, indent=1)


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
                     workers: int, out: str, reuse: bool = False,
                     procs: int = 0, full: bool = True,
                     supervisor_opts: Optional[dict] = None) -> Dict:
    """The teacher of ``teacher_checkpoint`` (trained, or random-init
    from ``seed + 1``), then its top-k of ``batches`` through
    ``generate_sharded`` over ``workers`` ledgered workers into
    ``<out>/logit_store``, verified.  Returns the reference's
    ``stage_targets`` report plus which teacher ran and the pass's
    seconds and frames/s.  ``reuse`` keeps a completed pass already in
    ``out`` (its ledger all done; verified, nothing forwarded) instead of
    superseding it: a resumed training stage reads the wave its
    checkpoint was trained on.  ``procs`` >= 1 runs the pass in that many
    OS processes, each a ``teacher_engine`` over the checkpoint
    (``full``: the published teacher, else its ``reduced`` widths); the
    report adds the fleet's ``processes``, ``restarts``, ``reclaimed``
    and the workers' exit reports.  ``supervisor_opts`` go to the fleet's
    ``Supervisor`` (``timeout_s``, ``heartbeat_timeout_s``, ...; None:
    its defaults)."""
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
    elif procs:
        t0 = time.perf_counter()
        rep = generate_sharded(
            "repro_torch.runtime.workers:teacher_engine", batches, store,
            n_workers=workers, ledger_path=ledger_path, processes=procs,
            engine_kwargs={"ckpt_dir": ckpt_dir, "k": TOPK,
                           "arch": "lstm-am-teacher", "reduced": not full,
                           "device": str(device)},
            supervisor_opts=supervisor_opts)
    else:
        t0 = time.perf_counter()
        rep = generate_sharded(
            lambda w: engine_from_checkpoint(teacher_cfg, ckpt_dir, TOPK,
                                             device),
            batches, store, n_workers=workers, ledger_path=ledger_path)
    _sync(device)
    gen_s = time.perf_counter() - t0
    store.verify()
    meta = store.stats()
    full_bytes = meta.n_frames * full_bytes_per_frame(teacher_cfg.n_senones)
    packed = meta.n_frames * storage_bytes_per_frame(TOPK)
    out = {"n_shards": rep["n_shards"], "n_frames": meta.n_frames,
           "n_workers": rep["n_workers"], "wave": rep["wave"],
           "resumed": rep["resumed"],
           "storage_compression_x": round(full_bytes / packed, 1),
           "teacher_ckpt": teacher,
           "device": str(device), "n_written": rep["n_written"],
           "frames_written": rep["frames_written"], "gen_s": gen_s,
           "frames_per_s": rep["frames_written"] / gen_s,
           "forward_s": rep["forward_s"], "write_s": rep["write_s"]}
    if "processes" in rep:
        out.update({k: rep[k] for k in ("processes", "restarts",
                                        "reclaimed", "workers")})
    return out


def stage_targets(*, full: bool, device, seed: int = 0, workers: int = 3,
                  procs: int = 0, out: str = "experiments/train_torch",
                  log=print, supervisor_opts: Optional[dict] = None) -> Dict:
    """Sharded target generation (the reference's
    ``SSLPipeline.stage_targets``; in ``procs`` OS processes when >= 1,
    under a ``Supervisor`` given ``supervisor_opts``)
    over ``make_target_batches`` of ``TARGET_SIZES``; writes
    ``<out>/train_targets.json``."""
    cfg = _teacher_cfg(full)
    n, rows, frames = TARGET_SIZES["full" if full else "reduced"]
    batches = make_target_batches(cfg, n=n, rows=rows, frames=frames,
                                  seed=seed)
    rep = generate_targets(cfg, batches, device=device, seed=seed,
                           workers=workers, out=out, procs=procs, full=full,
                           supervisor_opts=supervisor_opts)
    rep["teacher"] = cfg.name
    log(f"[train] {cfg.name} targets ({rep['teacher_ckpt']}) on "
        f"{rep['device']}: "
        f"{rep['n_written']} of {n} batches of {rows}x{frames} "
        f"({rep['frames_written']} frames) by {workers} workers"
        + (f" in {procs} processes ({rep['restarts']} restarts)"
           if procs else "")
        + f" in {rep['gen_s']:.2f} s = {rep['frames_per_s']:.1f} frames/s "
        f"(forwards {rep['forward_s']:.2f} s, store writes "
        f"{rep['write_s']:.3f} s); wave {rep['wave']}, resumed "
        f"{rep['resumed']}; {rep['n_shards']} shards verified, "
        f"{rep['storage_compression_x']}x smaller than full logits")
    _write(out, "targets", rep)
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
    _write(out, "student", results)
    return StudentRun(results, state, loss_fns, unl, store)


@dataclass
class BaselineRun:
    """What the baseline stage leaves behind: the printed results, the
    final TrainState, the CE loss function, the pipeline and the first
    (chunked) and last (full-sequence) batches it trained on."""
    results: Dict
    state: TrainState
    loss_fn: object
    pipe: SSLPipeline
    first_batch: dict
    last_batch: dict


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


def _corpus_pipeline(*, full: bool, device, seed: int, out: str,
                     trainer: str = "gtc", **over) -> SSLPipeline:
    return SSLPipeline(stage_config(full, seed=seed, **over), out_dir=out,
                       student_trainer=trainer, device=device)


def _fit_report(run, prefix: str = "") -> Dict:
    """A ``FitRun``'s counts and rates under ``prefix``."""
    return {f"{prefix}updates": run.state.step,
            f"{prefix}updates_run": len(run.sink.records),
            f"{prefix}resumed_at": run.resumed_at,
            f"{prefix}batches": run.batches,
            f"{prefix}source_s": run.source_s,
            f"{prefix}train_s": run.fit_s,
            # "train_frames" unprefixed, "ce_frames" / "smbr_frames"
            f"{prefix or 'train_'}frames": run.frames,
            f"{prefix}frames_per_s": run.frames / run.fit_s}


def stage_baseline(*, full: bool, device, seed: int = 0,
                   ckpt_every: int = CKPT_EVERY, prefetch: int = PREFETCH,
                   out: str = "experiments/train_torch",
                   log=print) -> BaselineRun:
    """``SSLPipeline.stage_baseline`` at ``stage_config(full)``: CE
    training of the student on the synthetic corpus under ``Local()``;
    final params into ``<out>/ckpt_baseline``, results (the pipeline's,
    plus the fit's counts and rates) into ``<out>/train_baseline.json``."""
    t0 = time.perf_counter()
    pipe = _corpus_pipeline(full=full, device=device, seed=seed, out=out,
                            ckpt_every=ckpt_every, prefetch=prefetch)
    mvn_s = time.perf_counter() - t0
    res = pipe.stage_baseline()
    run = pipe.fits["baseline"]
    results = {"device": str(pipe.device), "full": full,
               "n_labeled": pipe.pc.n_labeled, "prefetch": prefetch,
               "mvn_s": mvn_s, **_fit_report(run), **res}
    log(f"[train] baseline on {pipe.device}: {results['updates_run']} CE "
        f"updates over {pipe.pc.n_labeled} synthetic utterances "
        f"({run.frames:.0f} real frames) in {run.fit_s:.2f} s = "
        f"{results['frames_per_s']:.1f} frames/s ({run.source_s:.2f} s in "
        f"the corpus source; corpus MVN {mvn_s:.2f} s before)"
        + (f", resumed at update {run.resumed_at}" if run.resumed_at
           else ""))
    if res["loss_first"] is not None:
        log(f"[train] loss first {res['loss_first']:.4f} last "
            f"{res['loss_last']:.4f}; val FER {res['val_fer']:.4f}")
    _write(out, "baseline", results)
    return BaselineRun(
        results, run.state, run.loss_fns["ce"], pipe,
        pipe._batches(pipe.rng_labeled, chunked=True)[0],
        pipe._batches(pipe.rng_labeled, chunked=False)[-1])


def stage_teacher(*, full: bool, device, seed: int = 0,
                  ckpt_every: int = CKPT_EVERY, prefetch: int = PREFETCH,
                  out: str = "experiments/train_torch",
                  log=print) -> SeqRun:
    """``SSLPipeline.stage_teacher`` at ``stage_config(full)``: the
    biLSTM's CE fit on the corpus, then one epoch of sMBR fine-tune under
    ``Local(clip=0.0)``.  Final params into ``<out>/ckpt_teacher``,
    results (the pipeline's, plus each fit's counts and rates, prefixed
    ``ce_`` and ``smbr_``) into ``<out>/train_teacher.json``."""
    pipe = _corpus_pipeline(full=full, device=device, seed=seed, out=out,
                            ckpt_every=ckpt_every, prefetch=prefetch)
    res = pipe.stage_teacher()
    ce, sm = pipe.fits["teacher"], pipe.fits["teacher_smbr"]
    batches = pipe._batches(pipe.rng_labeled, chunked=False)
    results = {"device": str(pipe.device), "full": full, **res,
               "smbr_log_z": sm.sink.last("log_z"),
               **_fit_report(ce, "ce_"), **_fit_report(sm, "smbr_"),
               "smbr_batch": list(batches[0]["feats"].shape[:2])}
    eacc = res["smbr_eacc"]
    log(f"[train] teacher on {pipe.device}: {results['ce_updates_run']} CE "
        f"updates ({ce.frames:.0f} real frames) in {ce.fit_s:.2f} s = "
        f"{results['ce_frames_per_s']:.1f} frames/s, then "
        f"{results['smbr_updates_run']} sMBR updates of "
        f"{len(batches[0]['feats'])} full-sequence rows ({sm.frames:.0f} "
        f"real frames) in {sm.fit_s:.2f} s = "
        f"{results['smbr_frames_per_s']:.1f} frames/s"
        + (f"; sMBR eacc {eacc:.4g}, log Z {results['smbr_log_z']:.2f}"
           if eacc is not None else "")
        + f"; val FER {res['val_fer']:.4f}"
        + (f"; resumed at CE update {ce.resumed_at}" if ce.resumed_at
           else "")
        + (f", sMBR update {sm.resumed_at}" if sm.resumed_at else ""))
    log("[train] " + json.dumps(res))
    _write(out, "teacher", results)
    return SeqRun(results, sm.state, sm.loss_fns["smbr"], pipe._graph(),
                  batches)


def stage_smbr(*, full: bool, device, seed: int = 0, trainer: str = "gtc",
               gtc_workers: int = PipelineConfig.gtc_workers,
               ckpt_every: int = CKPT_EVERY, prefetch: int = PREFETCH,
               out: str = "experiments/train_torch",
               log=print) -> SeqRun:
    """``SSLPipeline.stage_smbr`` at ``stage_config(full)``: sequence
    training of the student from ``<out>/ckpt_student_<trainer>``, else
    ``<out>/ckpt_baseline``, two sMBR epochs under ``GTCShardMap`` at W =
    ``gtc_workers`` (each update one padded full-sequence batch per
    worker, the int8 wire, no clip), or the single-process ``GTC`` at 1.
    Final params into ``<out>/ckpt_smbr``, results (the pipeline's, plus
    the fit's counts and rates) into ``<out>/train_smbr.json``."""
    pipe = _corpus_pipeline(full=full, device=device, seed=seed, out=out,
                            trainer=trainer, gtc_workers=gtc_workers,
                            ckpt_every=ckpt_every, prefetch=prefetch)
    start = f"student_{trainer}"
    if pipe._ckpt(start).latest() is None:
        start = "baseline"
    res = pipe.stage_smbr()
    run = pipe.fits["smbr"]
    strategy = run.trainer.strategy
    batches = pipe._batches(pipe.rng_labeled, chunked=False,
                            uniform_len=gtc_workers > 1)
    results = {**res, "device": str(pipe.device), "full": full,
               "start": start, "gtc_workers": gtc_workers,
               "microbatches": strategy.microbatches,
               "batch": list(batches[0]["feats"].shape[:2]),
               "prefetch": prefetch, **_fit_report(run),
               "log_z": run.sink.values("log_z"),
               "gtc_density": run.sink.values("gtc_density")}
    n_run = results["updates_run"]
    log(f"[train] sMBR on {pipe.device} from {start}: {n_run} updates of "
        f"{strategy.microbatches} x {results['batch'][0]}x"
        f"{results['batch'][1]} frames (W = {gtc_workers}, "
        f"{run.frames:.0f} real frames) in {run.fit_s:.2f} s = "
        f"{results['frames_per_s']:.1f} frames/s"
        + (f"; eacc {res['eacc_first']:.4g} -> {res['eacc_last']:.4g}, "
           f"gtc_density last {results['gtc_density'][-1]:.4g}"
           if n_run else "")
        + f"; val FER {res['val_fer']:.4f} (baseline "
        f"{res['baseline_fer']:.4f})"
        + (f", resumed at update {run.resumed_at}" if run.resumed_at
           else ""))
    log("[train] " + json.dumps(res))
    _write(out, "smbr", results)
    return SeqRun(results, run.state, run.loss_fns["smbr"], pipe._graph(),
                  batches)


def run_pipeline(args) -> Dict:
    """``SSLPipeline(...).run(args.stage)`` at ``args.scale``; the results
    printed and written to ``<out>/train_<stage>.json``."""
    pc = {"tiny": PipelineConfig.tiny, "small": PipelineConfig.small}[
        args.scale]()
    if args.gen_workers is not None:
        pc.gen_workers = args.gen_workers
    if args.gtc_workers is not None:
        pc.gtc_workers = args.gtc_workers
    if args.prefetch is not None:
        pc.prefetch = args.prefetch
    pc.gen_procs = args.gen_procs
    pipe = SSLPipeline(pc, out_dir=args.out, student_trainer=args.trainer,
                       device=args.device)
    t0 = time.time()
    results = pipe.run(stage=args.stage)
    print(f"[train] stage={args.stage} done in {time.time() - t0:.1f}s on "
          f"{pipe.device}")
    with open(os.path.join(args.out, f"train_{args.stage}.json"), "w") as f:
        json.dump(results, f, indent=1, default=float)
    for k, v in results.items():
        print(f"  {k}: {v}")
    for stage, st in pipe.stats.items():
        print(f"[train] {stage}: {st['seconds']:.2f} s, {st['frames']:.0f} "
              f"real frames in {st['fit_s']:.2f} s = "
              f"{st['frames'] / st['fit_s']:.1f} frames/s"
              + (f" ({st['source_s']:.2f} s in the corpus source)"
                 if "source_s" in st else ""))
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="lstm-am-7khr")
    ap.add_argument("--stage", default="all",
                    choices=["all", "baseline", "teacher", "targets",
                             "student", "smbr"])
    ap.add_argument("--trainer", default="gtc", choices=["gtc", "bmuf"])
    ap.add_argument("--scale", default="tiny", choices=["tiny", "small"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true",
                    help="one stand-alone stage at the published width")
    ap.add_argument("--seed", type=int, default=None,
                    help="--full: the random weights' and data's seed "
                         "(default 0)")
    ap.add_argument("--steps", type=int, default=None,
                    help="--full --stage student: stop after this many "
                         "updates (default 0: the whole schedule)")
    ap.add_argument("--gen-workers", type=int, default=None,
                    help="target-generation workers (ledgered disjoint "
                         "shard ranges; default: PipelineConfig's 2)")
    ap.add_argument("--gtc-workers", type=int, default=None,
                    help="sMBR workers: >1 runs GTCShardMap, 1 the "
                         "single-process GTC (default 2)")
    ap.add_argument("--prefetch", type=int, default=None,
                    help="batches staged ahead on a side stream (0: the "
                         "synchronous feed; default 2)")
    ap.add_argument("--gen-procs", type=int, default=0,
                    help="target generation in N OS processes, each "
                         "rebuilding the engine from the checkpoint "
                         "(default 0: in-process)")
    ap.add_argument("--cluster", default="",
                    help="multi-host launch (not ported yet: step 8b)")
    ap.add_argument("--out", default="experiments/train_torch")
    args = ap.parse_args(argv)
    if args.arch != "lstm-am-7khr":
        raise NotImplementedError(
            f"--arch {args.arch} is not ported yet: only the lstm-am-7khr "
            "stages are (ROADMAP Queue 1, step 10: token-LM side branch)")
    if args.cluster:
        raise NotImplementedError(f"--cluster is not ported yet ({_ELASTIC})")
    if not args.full:
        if args.seed is not None or args.steps is not None:
            raise ValueError("--seed and --steps apply to --full; the "
                             "pipeline runs PipelineConfig's seed and "
                             "schedule at --scale")
        return run_pipeline(args)
    if args.stage == "all":
        raise ValueError("--full runs one stage at the published width; "
                         "the pipeline end to end runs at --scale "
                         "tiny|small (drop --full)")
    pc = PipelineConfig()
    prefetch = pc.prefetch if args.prefetch is None else args.prefetch
    common = dict(full=True, device=args.device, seed=args.seed or 0,
                  out=args.out)
    if args.stage == "targets":
        workers = pc.gen_workers if args.gen_workers is None \
            else args.gen_workers
        return stage_targets(workers=workers, procs=args.gen_procs,
                             **common)
    if args.stage == "baseline":
        return stage_baseline(prefetch=prefetch, **common).results
    if args.stage == "teacher":
        return stage_teacher(prefetch=prefetch, **common).results
    if args.stage == "smbr":
        workers = pc.gtc_workers if args.gtc_workers is None \
            else args.gtc_workers
        return stage_smbr(trainer=args.trainer, gtc_workers=workers,
                          prefetch=prefetch, **common).results
    return stage_student(steps=args.steps or 0, trainer=args.trainer,
                         prefetch=prefetch, **common).results

if __name__ == "__main__":
    main()
