"""Trainer CLI: the paper's target generation and student stages on
the card.

The twin of the reference's ``launch/train.py`` for ``--arch
lstm-am-7khr`` at two stages of ``core/ssl_pipeline.py``, with random
weights and random features from ``--seed``:

``--stage targets`` (``stage_targets``, paper §3.2.2 "parallelize target
generation"):
  (a) the random-init teacher (``lstm-am-teacher``, biLSTM, seed + 1) is
      written into ``CheckpointStore(<out>/ckpt_teacher)``;
  (b) ``--workers`` in-process workers, each with its own
      ``TeacherRunner`` rebuilt from that checkpoint, run
      ``pipeline.generate_sharded`` over ragged unlabeled batches into
      the manifest-backed ``LogitStoreV2(<out>/logit_store)`` (the
      ``topk_logits`` kernel, one launch a batch), ledgered in
      ``<out>/gen_ledger.json``: a killed run resumes its unfinished
      ranges, a completed one is superseded by the next wave;
  (c) ``store.verify()`` checksums every shard; the report (the
      reference's keys, frames/s of generation, the seconds in forwards
      and in store writes) is printed and written to
      ``<out>/train_targets.json``.

``--stage student`` (``stage_student``, §3.2.2-3.3):
  (a) the same target generation, one worker, over the student's
      unlabeled batches;
  (b) ``Trainer(GTC(GTCConfig(tau=2e-4, n_workers=1)), {"distill_topk",
      "ce"})`` fits ``scheduled_source`` over ``distill_shard_source``
      sub-epochs (``pin_wave=True`` on the verified store) interleaved
      with labeled CE passes on random labels (the ``sparse_ce`` kernel
      in the distill loss, the ``gtc_compress`` kernel on every gradient
      leaf);
  (c) it prints the updates, frames/s of training, the first and last
      loss and the GTC density, and writes them to
      ``<out>/train_student.json``.

Runs on the card by default; ``--device cpu`` runs the plain PyTorch
path on the host.  ``--full`` is the published width (5x768 student and
teacher, 3,183 senones; targets over 12 batches of 16 x 512 frames, the
student on batches of 16 x 64); without it the reduced config at small
batches.

  PYTHONPATH=src python -m repro_torch.launch.train --stage targets --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --stage targets --full --workers 3
  PYTHONPATH=src python -m repro_torch.launch.train --stage student --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --stage student --full

The other stages and ``--trainer bmuf`` raise, naming the ROADMAP item
that brings them.
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
from repro_torch.distributed.gtc import GTCConfig
from repro_torch.kernels._dispatch import resolve_device
from repro_torch.launch.steps import make_loss_fn
from repro_torch.models import LstmAM, build_model
from repro_torch.pipeline import generate_sharded
from repro_torch.store import (LogitStoreV2, full_bytes_per_frame,
                               storage_bytes_per_frame)
from repro_torch.train import data as train_data
from repro_torch.train import (GTC, ListSink, TrainBatch, Trainer,
                               TrainState, distill_shard_source,
                               scheduled_source)

TOPK = 20
GTC_TAU = 2e-4
# PipelineConfig's student schedule, cut to two sub-epochs
SCHEDULE = ScheduleConfig(n_sub_epochs=2, sub_epoch_hours=1.0,
                          labeled_every=1, chunked_until=3, lr0=5e-2,
                          labeled_lr_boost=1.5)
# (rows per batch, frames per row, unlabeled batches per sub-epoch,
#  labeled batches per pass)
SIZES = {"full": (16, 64, 4, 2), "reduced": (4, 16, 4, 2)}
# --stage targets: (batches, rows per batch, frames per row); row lengths
# are drawn from [frames / 4, frames]
TARGET_SIZES = {"full": (12, 16, 512), "reduced": (3, 4, 16)}

NOT_PORTED = {
    "all": "ROADMAP Queue 1: the pipeline end to end",
    "baseline": "ROADMAP Queue 1: labeled stages and BMUF",
    "teacher": "ROADMAP Queue 1: labeled stages and BMUF",
    "smbr": "ROADMAP Queue 1: sMBR and multi-worker GTC",
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


def generate_targets(teacher_cfg, batches: List[dict], *, device, seed: int,
                     workers: int, out: str) -> Dict:
    """The random-init teacher (``seed + 1``) into
    ``<out>/ckpt_teacher``, then its top-k of ``batches`` through
    ``generate_sharded`` over ``workers`` ledgered workers into
    ``<out>/logit_store``, verified.  Returns the reference's
    ``stage_targets`` report plus the pass's seconds and frames/s."""
    device = resolve_device(device)
    ckpt_dir = os.path.join(out, "ckpt_teacher")
    teacher = build_model(teacher_cfg, device="cpu",
                          generator=torch.Generator().manual_seed(seed + 1))
    CheckpointStore(ckpt_dir).save(0, teacher.state_dict())
    del teacher
    store = LogitStoreV2(os.path.join(out, "logit_store"), k=TOPK,
                         vocab=teacher_cfg.n_senones)
    t0 = time.perf_counter()
    rep = generate_sharded(
        lambda w: _engine_from_ckpt(teacher_cfg, ckpt_dir, TOPK, device),
        batches, store, n_workers=workers,
        ledger_path=os.path.join(out, "gen_ledger.json"))
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
    log(f"[train] {cfg.name} targets on {rep['device']}: "
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


def stage_student(*, full: bool, device, seed: int = 0, steps: int = 0,
                  out: str = "experiments/train_torch",
                  log=print) -> StudentRun:
    """Teacher targets -> scheduled GTC distillation of the student.
    ``steps`` > 0 stops after that many updates (0: the whole schedule)."""
    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    student_cfg = get_arch("lstm-am-7khr")
    if not full:
        student_cfg = reduced(student_cfg)
    teacher_cfg = _teacher_cfg(full)
    rows, frames, per_sub, per_pass = SIZES["full" if full else "reduced"]
    unl, lab = make_batches(student_cfg, rows=rows, frames=frames,
                            n_unlabeled=SCHEDULE.n_sub_epochs * per_sub,
                            n_labeled=per_pass, seed=seed)

    # (a) teacher targets into the v2 store, one worker; the workers=1
    # consumer's contract is the manifest: verify() checksums every shard
    gen = generate_targets(teacher_cfg, unl, device=device, seed=seed,
                           workers=1, out=out)
    store = LogitStoreV2(os.path.join(out, "logit_store"), k=TOPK,
                         vocab=teacher_cfg.n_senones)
    store.verify()

    # (b) scheduled learning under GTC
    student = build_model(student_cfg, device=device,
                          generator=torch.Generator().manual_seed(seed))
    loss_fns = {"distill_topk": make_loss_fn(student, student_cfg,
                                             "distill_topk"),
                "ce": make_loss_fn(student, student_cfg, "ce")}
    sink = ListSink()
    trainer = Trainer(GTC(GTCConfig(tau=GTC_TAU, n_workers=1)), loss_fns,
                      metrics=sink)
    state = trainer.init_state(dict(student.state_dict()), seed=seed)

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
    state = trainer.fit(state, scheduled_source(SCHEDULE, unlabeled=unlabeled,
                                                labeled=labeled),
                        max_updates=steps or None)
    _sync(device)
    train_s = time.perf_counter() - t0

    # (c) results
    losses = sink.values("loss")
    n_frames = state.step * rows * frames
    results = {
        "device": str(device), "full": full,
        "student": student_cfg.name, "teacher": teacher_cfg.name,
        "batch": [rows, frames], "shards": gen["n_shards"],
        "targets_s": gen["gen_s"], "targets_wave": gen["wave"],
        "shard_copies": train_data.SHARD_COPIES, "updates": state.step,
        "updates_by_loss": {t: sum(1 for _, tg, _ in sink.records
                                   if tg == t) for t in loss_fns},
        "train_s": train_s, "train_frames": n_frames,
        "frames_per_s": n_frames / train_s,
        "loss_first": losses[0], "loss_last": losses[-1],
        "gtc_density": sink.values("gtc_density"),
    }
    log(f"[train] {student_cfg.name} student stage on {device}: "
        f"{len(unl)} teacher batches -> {results['shards']} shards "
        f"(wave {gen['wave']}) in {gen['gen_s']:.2f} s; {state.step} updates "
        f"({results['updates_by_loss']}) of {rows}x{frames} frames in "
        f"{train_s:.2f} s = {results['frames_per_s']:.1f} frames/s")
    dens = results["gtc_density"]
    log(f"[train] loss first {losses[0]:.4f} last {losses[-1]:.4f}; "
        f"gtc_density first {dens[0]:.4f} last {dens[-1]:.4f}")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "train_student.json"), "w") as f:
        json.dump(results, f, indent=1)
    return StudentRun(results, state, loss_fns, unl, store)


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
                         "schedule, 12 updates)")
    ap.add_argument("--workers", type=int, default=3,
                    help="--stage targets: in-process generation workers")
    ap.add_argument("--out", default="experiments/train_torch")
    args = ap.parse_args(argv)
    if args.arch != "lstm-am-7khr":
        raise NotImplementedError(
            f"--arch {args.arch} is not ported yet: only the lstm-am-7khr "
            "targets and student stages are (ROADMAP Queue 1: token-LM "
            "side branch)")
    if args.stage in NOT_PORTED:
        raise NotImplementedError(f"--stage {args.stage} is not ported yet "
                                  f"({NOT_PORTED[args.stage]})")
    if args.trainer != "gtc":
        raise NotImplementedError("--trainer bmuf is not ported yet "
                                  "(ROADMAP Queue 1: labeled stages and "
                                  "BMUF)")
    if args.stage == "targets":
        return stage_targets(full=args.full, device=args.device,
                             seed=args.seed, workers=args.workers,
                             out=args.out)
    return stage_student(full=args.full, device=args.device, seed=args.seed,
                         steps=args.steps, out=args.out).results


if __name__ == "__main__":
    main()
