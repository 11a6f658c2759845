"""Trainer CLI: the paper's student stage on the card.

The twin of the reference's ``launch/train.py`` for
``--arch lstm-am-7khr --stage student --trainer gtc``, the stage of
``core/ssl_pipeline.py:stage_student``.  With random weights and random
features from ``--seed`` it does what that stage does:

  (a) the teacher (``lstm-am-teacher``, biLSTM) writes the top-20 of N
      unlabeled batches into a v1 ``LogitStore`` under ``--out``, through
      ``TeacherRunner.generate_to_store`` (the ``topk_logits`` kernel);
  (b) ``Trainer(GTC(GTCConfig(tau=2e-4, n_workers=1)), {"distill_topk",
      "ce"})`` fits ``scheduled_source`` over ``distill_shard_source``
      sub-epochs interleaved with labeled CE passes on random labels
      (the ``sparse_ce`` kernel in the distill loss, the
      ``gtc_compress`` kernel on every gradient leaf);
  (c) it prints the updates, frames/s of training, the first and last
      loss and the GTC density, and writes them to
      ``<out>/train_student.json``.

Runs on the card by default; ``--device cpu`` runs the plain PyTorch
path on the host.  ``--full`` is the published width (5x768 student and
teacher, 3,183 senones, batches of 16 x 64 frames); without it the
reduced config at small batches.

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

from repro_torch.configs import get_arch, reduced
from repro_torch.core.logit_store import LogitStore
from repro_torch.core.scheduled import ScheduleConfig
from repro_torch.core.teacher import TeacherRunner, make_teacher_config
from repro_torch.distributed.gtc import GTCConfig
from repro_torch.kernels._dispatch import resolve_device
from repro_torch.launch.steps import make_loss_fn
from repro_torch.models import build_model
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

NOT_PORTED = {
    "all": "ROADMAP Queue 1: the pipeline end to end",
    "baseline": "ROADMAP Queue 1: labeled stages and BMUF",
    "teacher": "ROADMAP Queue 1: labeled stages and BMUF",
    "targets": "ROADMAP Queue 1: target generation at scale",
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
    store: LogitStore


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


def stage_student(*, full: bool, device, seed: int = 0, steps: int = 0,
                  out: str = "experiments/train_torch",
                  log=print) -> StudentRun:
    """Teacher targets -> scheduled GTC distillation of the student.
    ``steps`` > 0 stops after that many updates (0: the whole schedule)."""
    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    student_cfg = get_arch("lstm-am-7khr")
    teacher_cfg = make_teacher_config(student_cfg)
    if not full:
        student_cfg = reduced(student_cfg)
        teacher_cfg = reduced(get_arch("lstm-am-teacher"))
    rows, frames, per_sub, per_pass = SIZES["full" if full else "reduced"]
    unl, lab = make_batches(student_cfg, rows=rows, frames=frames,
                            n_unlabeled=SCHEDULE.n_sub_epochs * per_sub,
                            n_labeled=per_pass, seed=seed)

    # (a) teacher targets into the v1 store
    teacher = build_model(teacher_cfg, device=device,
                          generator=torch.Generator().manual_seed(seed + 1))
    store = LogitStore(os.path.join(out, "logit_store"), k=TOPK,
                       vocab=teacher_cfg.n_senones)
    runner = TeacherRunner(teacher_cfg, teacher.state_dict(), k=TOPK,
                           device=device)
    t0 = time.perf_counter()
    runner.generate_to_store(store, unl)
    _sync(device)
    gen_s = time.perf_counter() - t0

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
        return distill_shard_source(unl, store, lo, lo + per_sub, phase.lr)

    def labeled(phase):
        o = max(phase.feature_offset, 0)
        return (TrainBatch({"feats": b["feats"][:, o:o + frames],
                            "labels": b["labels"], "mask": b["mask"]},
                           phase.lr, "ce") for b in lab)

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
        "batch": [rows, frames], "shards": len(store.shards()),
        "targets_s": gen_s, "updates": state.step,
        "updates_by_loss": {t: sum(1 for _, tg, _ in sink.records
                                   if tg == t) for t in loss_fns},
        "train_s": train_s, "train_frames": n_frames,
        "frames_per_s": n_frames / train_s,
        "loss_first": losses[0], "loss_last": losses[-1],
        "gtc_density": sink.values("gtc_density"),
    }
    log(f"[train] {student_cfg.name} student stage on {device}: "
        f"{len(unl)} teacher batches -> {results['shards']} shards in "
        f"{gen_s:.2f} s; {state.step} updates "
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
    ap.add_argument("--out", default="experiments/train_torch")
    args = ap.parse_args(argv)
    if args.arch != "lstm-am-7khr":
        raise NotImplementedError(
            f"--arch {args.arch} is not ported yet: only the lstm-am-7khr "
            "student stage is (ROADMAP Queue 1: token-LM side branch)")
    if args.stage != "student":
        raise NotImplementedError(f"--stage {args.stage} is not ported yet "
                                  f"({NOT_PORTED[args.stage]})")
    if args.trainer != "gtc":
        raise NotImplementedError("--trainer bmuf is not ported yet "
                                  "(ROADMAP Queue 1: labeled stages and "
                                  "BMUF)")
    return stage_student(full=args.full, device=args.device, seed=args.seed,
                         steps=args.steps, out=args.out).results


if __name__ == "__main__":
    main()
