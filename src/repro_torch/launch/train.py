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

**The token LMs** (the reference's ``train_llm_smoke``): ``--arch <id>``
for any id but ``lstm-am-7khr``, or ``--smoke``, trains
``reduced(get_arch(id))`` for ``--steps`` (default 4) CE updates of 2 x
64 synthetic tokens through ``Trainer(Local(optimizer="adam"))`` at lr
3e-4 and prints each loss (``train_llm_smoke``): the full-sequence
attention through the ``swa_attention`` kernel and its backward on the
card, MoE's aux and deepseek-v3's multi-token prediction in the loss.

All routes run on the card by default; ``--device cpu`` (or
``REPRO_PLATFORM=cpu``, ``runtime/env.py``) runs the plain PyTorch path
on the host.  ``--gen-procs N`` runs target generation in N OS processes
(``runtime/workers.py``'s Supervisor; each worker rebuilds the engine
from the checkpoint on disk, on ``--device``), on both routes.
``--stage waves`` is the port's own test route, with fault injection on
(the reference's launcher has no such stage): ``SSLPipeline.run_waves()``
at ``--scale`` under ``--trainer bmuf``, from ``<out>/ckpt_baseline`` and
``<out>/ckpt_teacher``, two waves, each killing a lane at block 1 and
reviving it two blocks later.

**``--cluster host:port,N,i``** (or ``env``: ``REPRO_COORDINATOR``,
``REPRO_NUM_PROCESSES``, ``REPRO_PROCESS_ID``) makes this process rank i
of N (``runtime/cluster.py``; ``REPRO_DIST_BACKEND=gloo|nccl``, default
nccl on the card and gloo on the host; ranks sharing one card need
gloo).  Start one process per rank with the same arguments; each runs
on its own device (``cuda:(rank % device_count)``, or the host).  At
``--scale`` every ``--stage`` (``all`` and ``waves`` included) runs
across ranks, as ``core/ssl_pipeline.py`` says: sMBR's lanes
(``GTCShardMap`` on ``worker_mesh(--gtc-workers)``) and the BMUF
student's (``BMUFShardMap`` on ``worker_mesh(bmuf_workers)``) split over
the ranks, target generation splits the ledger's ranges over them (with
``--gen-procs P``, P worker processes in every rank, on its device),
and the baseline, the teacher and the GTC student run replicated in
every rank.  ``--stage waves`` (``--trainer bmuf``) runs
``SSLPipeline.run_waves()`` from the baseline and teacher under
``--out``: rank 0 holds the lanes' roster and its crash plan, and every
rank's student resizes to the W it broadcasts.  At ``--full`` two routes
do: ``--stage smbr`` and ``--stage student --trainer bmuf``
(``BMUFShardMap`` on ``worker_mesh(4)``; rank 0 alone writes any
targets that are missing).  Rank 0 writes the checkpoints and results
while the others wait.  Each rank writes its report to
``<out>/_ranks/rank<i>.json``: device, kernel launches, start-up and
stage seconds; on the routes with a mesh its lanes and an update's wall
split (the sMBR lanes' gradients, local pack, the all-reduce and the
unpack, or BMUF's block sync), with rank 0's gathered final TrainState
in ``state.pt``; at ``--scale`` each stage's seconds, real frames,
launches, this rank's difference from rank 0's checkpoint, its lanes and
the ranges it generated (``stages``).  The other ``--full`` routes raise
before a process group exists: they are the port's own, and the
reference's launcher, which has no ``--full``, gives them no
across-ranks behaviour to follow.

  # two gloo ranks on the host (one terminal each, or & the first):
  REPRO_DIST_BACKEND=gloo python -m repro_torch.launch.train --cluster 127.0.0.1:29500,2,0 --stage all --device cpu
  REPRO_DIST_BACKEND=gloo python -m repro_torch.launch.train --cluster 127.0.0.1:29500,2,1 --stage all --device cpu
  # then the waves, each rank generating in one worker process:
  REPRO_DIST_BACKEND=gloo python -m repro_torch.launch.train --cluster 127.0.0.1:29500,2,<i> --stage waves --trainer bmuf --gen-procs 1 --device cpu

  PYTHONPATH=src python -m repro_torch.launch.train --stage all --scale tiny
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b --smoke --device cpu
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
from repro_torch.runtime import cluster
from repro_torch.runtime.env import bootstrap_from_env
from repro_torch.runtime.workers import engine_from_checkpoint, process_report
from repro_torch.store import (LogitStoreV2, full_bytes_per_frame,
                               storage_bytes_per_frame)
from repro_torch.train import data as train_data
from repro_torch.train import (GTC, BMUFShardMap, BMUFVmap, ListSink,
                               TrainBatch, Trainer, TrainState,
                               distill_shard_source, scheduled_source)

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


LM_LR = 3e-4                     # the reference's train_llm_smoke


def lm_batches(cfg, batch: int, seq: int, n: int, seed: int = 0):
    """The reference's ``token_batches(cfg.vocab_size, batch, seq, n)``
    (the same draws); an encoder-decoder's batches add ``enc_embeds``
    (B, seq, D) ~ N(0, 0.01) from a second generator at ``seed``, the
    stubbed frontend's frames, which the reference's smoke leaves out."""
    from repro_torch.data.loader import token_batches
    rng = np.random.default_rng(seed)
    for b in token_batches(cfg.vocab_size, batch, seq, n, seed=seed):
        if cfg.encoder is not None:
            b["enc_embeds"] = (0.1 * rng.normal(
                size=(batch, seq, cfg.d_model))).astype(np.float32)
        yield b


def train_llm_smoke(arch: str, steps: int = 4, batch: int = 2, seq: int = 64,
                    *, device=None, params: Optional[Dict] = None,
                    seed: int = 0) -> List[float]:
    """The reference's LLM smoke: ``reduced(get_arch(arch))`` trained
    for ``steps`` CE updates of ``lm_batches`` through
    ``Trainer(Local(optimizer="adam"))`` at lr 3e-4, on ``device`` (the
    card by default).  Weights are ``params`` (a state dict, e.g. the
    reference's carried by ``checkpoint/convert.py``) or drawn from
    ``seed`` (the reference draws ``init(key(0))``, which a torch
    generator cannot repeat).  Returns the per-step losses; raises if one
    is not finite."""
    from repro_torch.train import Local, epoch_source
    cfg = reduced(get_arch(arch))
    dev = resolve_device(device)
    if params is None:
        model = build_model(cfg, device=dev, generator=torch.Generator(
            device=dev).manual_seed(seed))
    else:
        model = build_model(cfg, device=dev, params=params)
    sink = ListSink()
    trainer = Trainer(Local(optimizer="adam"),
                      {"ce": make_loss_fn(model, cfg, "ce")}, metrics=sink)
    state = trainer.init_state(dict(model.state_dict()))
    trainer.fit(state, epoch_source(
        lambda ep: lm_batches(cfg, batch, seq, steps), 1, LM_LR, "ce"),
        resume=False)
    losses = [float(x) for x in sink.values("loss")]
    for x in losses:
        print(f"  step loss={x:.4f}")
    if not np.isfinite(losses).all() or len(losses) != steps:
        raise FloatingPointError(f"{arch}: losses {losses}")
    return losses


@dataclass
class StudentRun:
    """What one student stage leaves behind: the printed results, the
    final TrainState, the loss functions and the data it trained on."""
    results: Dict
    state: TrainState
    loss_fns: Dict
    unlabeled: List[dict]
    store: LogitStoreV2
    strategy: object = None


def _write(out: str, stage: str, results: Dict):
    """``results`` into ``<out>/train_<stage>.json`` (rank 0's, under a
    fleet)."""
    def write():
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, f"train_{stage}.json"), "w") as f:
            json.dump(results, f, indent=1, default=float)
    cluster.on_leader(write)


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
    if cluster.world_size() > 1 and trainer != "bmuf":
        raise NotImplementedError(
            "the --full GTC student across processes is not ported yet "
            "(ROADMAP Queue 1, item 4: step 8c's rest); under --cluster "
            "the --full student stage runs --trainer bmuf")
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
    # A resumed stage keeps the completed pass its checkpoint trained on;
    # under a fleet rank 0 alone writes what is missing, and the other
    # ranks then read the completed pass
    ckpt = _state_store(out, f"student_{trainer}")
    resumed_at = ckpt.latest()
    fleet = cluster.world_size() > 1

    def targets():
        return generate_targets(teacher_cfg, unl, device=device, seed=seed,
                                workers=1, out=out,
                                reuse=fleet or resumed_at is not None)
    gen = cluster.on_leader(targets) or targets()
    store = LogitStoreV2(os.path.join(out, "logit_store"), k=TOPK,
                         vocab=teacher_cfg.n_senones)
    store.verify()

    # (b) scheduled learning under the trainer
    student = build_model(student_cfg, device=device,
                          generator=torch.Generator().manual_seed(seed))
    loss_fns = {"distill_topk": make_loss_fn(student, student_cfg,
                                             "distill_topk"),
                "ce": make_loss_fn(student, student_cfg, "ce")}
    if trainer == "gtc":
        strategy = GTC(GTCConfig(tau=GTC_TAU, n_workers=1))
    elif fleet:
        strategy = BMUFShardMap(BMUF, cluster.worker_mesh(BMUF.n_workers))
    else:
        strategy = BMUFVmap(BMUF)
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
    cluster.on_leader(lambda: CheckpointStore(
        os.path.join(out, f"ckpt_student_{trainer}")).save(0, state.params))

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
    return StudentRun(results, state, loss_fns, unl, store, strategy)


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
    strategy: object = None


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
                  batches, strategy)


def make_pipeline(args) -> SSLPipeline:
    """The ``SSLPipeline`` at ``args.scale`` with the CLI's overrides."""
    pc = {"tiny": PipelineConfig.tiny, "small": PipelineConfig.small}[
        args.scale]()
    if args.gen_workers is not None:
        pc.gen_workers = args.gen_workers
    if args.gtc_workers is not None:
        pc.gtc_workers = args.gtc_workers
    if args.prefetch is not None:
        pc.prefetch = args.prefetch
    pc.gen_procs = args.gen_procs
    return SSLPipeline(pc, out_dir=args.out, student_trainer=args.trainer,
                       device=args.device)


def run_pipeline(args, pipe: Optional[SSLPipeline] = None) -> Dict:
    """``SSLPipeline(...).run(args.stage)`` at ``args.scale`` (``pipe``,
    else ``make_pipeline(args)``; ``run_waves()``, its two waves, for
    ``--stage waves``); the results printed and written to
    ``<out>/train_<stage>.json``."""
    pipe = pipe or make_pipeline(args)
    t0 = time.time()
    results = (pipe.run_waves() if args.stage == "waves"
               else pipe.run(stage=args.stage))
    print(f"[train] stage={args.stage} done in {time.time() - t0:.1f}s on "
          f"{pipe.device}")

    def write():
        with open(os.path.join(args.out, f"train_{args.stage}.json"),
                  "w") as f:
            json.dump(results, f, indent=1, default=float)
    cluster.on_leader(write)
    for k, v in results.items():
        print(f"  {k}: {v}")
    for stage, st in pipe.stats.items():
        print(f"[train] {stage}: {st['seconds']:.2f} s, {st['frames']:.0f} "
              f"real frames in {st['fit_s']:.2f} s = "
              f"{st['frames'] / st['fit_s']:.1f} frames/s"
              + (f" ({st['source_s']:.2f} s in the corpus source)"
                 if "source_s" in st else ""))
    return results


# --------------------------------------------------------------- cluster

def _cluster_refusal(args) -> Optional[str]:
    """What in ``args`` does not run across ranks (None: all of it
    does): a ``--full`` route other than smbr and the BMUF student."""
    if args.full and not (args.stage == "smbr" or (
            args.stage == "student" and args.trainer == "bmuf")):
        return f"--full --stage {args.stage} --trainer {args.trainer}"
    return None


def _span(device, fn, runs: int):
    """Median host ms of ``fn()`` (each run between two syncs), and on
    the card the median CUDA-event ms, over ``runs`` runs."""
    import statistics
    host, dev = [], []
    for _ in range(runs):
        _sync(device)
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
        t = time.perf_counter()
        fn()
        if device.type == "cuda":
            b.record()
        _sync(device)
        host.append((time.perf_counter() - t) * 1e3)
        if device.type == "cuda":
            dev.append(a.elapsed_time(b))
    return {"host_ms": statistics.median(host),
            "event_ms": statistics.median(dev) if dev else None}


def gtc_update_split(strategy, loss_fn, state: TrainState,
                     batches: List[dict], device, *, runs: int = 3) -> Dict:
    """One ``GTCShardMap`` update's wall on this rank, in its parts:
    this rank's lanes' gradients, the local compress + pack + sum, the
    ``all_reduce`` of the partial sums (after a barrier, so the ranks
    start it together), and the unpack.  Every rank calls it with the
    same arguments; each part's host and CUDA-event ms (``_span``)."""
    from repro_torch.distributed import gtc as gtc_lib
    from repro_torch.train.strategies import loss_and_grads
    cfg, mesh = strategy.cfg, strategy.mesh
    stacked = strategy.stack(batches[:cfg.n_workers])
    res = state.strategy_state["residual"]
    lanes = range(len(mesh.lanes))
    got = {}

    def grads():
        got["g"] = [loss_and_grads(loss_fn, state.params,
                                   {k: v[j] for k, v in stacked.items()})[2]
                    for j in lanes]

    def pack():
        got["acc"], _ = gtc_lib.local_sum(lambda j: got["g"][j], res, cfg)

    def reduce():
        gtc_lib.all_reduce_tree(got["acc"], mesh)

    def unpack():
        got["u"] = {n: gtc_lib.wire_unpack(a, cfg)
                    for n, a in got["acc"].items()}

    out = {}
    for name, fn in (("grads", grads), ("pack", pack), ("all_reduce", reduce),
                     ("unpack", unpack)):
        if name == "all_reduce":
            cluster.barrier()
        out[name] = _span(device, fn, runs)
    out["wire_bytes"] = sum(a.numel() * a.element_size()
                            for a in got["acc"].values())
    return out


def bmuf_sync_ms(strategy, state: TrainState, device, *,
                 runs: int = 10) -> Dict:
    """``BMUFShardMap``'s block sync on this rank (the all-reduce of the
    lanes' sums and the update), after a barrier; ``_span``'s ms."""
    from repro_torch.distributed import bmuf as bmuf_lib
    mesh = strategy.mesh
    bstate = {"theta_g": state.params, **state.strategy_state}
    cluster.barrier()
    return _span(device, lambda: bmuf_lib.block_sync(
        bstate, strategy.cfg,
        mean_fn=bmuf_lib.mesh_mean_fn(mesh, strategy.cfg.n_workers)), runs)


def _host(tree):
    """Nested dicts of tensors (and arrays) copied to the host."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return torch.as_tensor(tree).detach().to("cpu", copy=True)


def rank_report(args, run, times: Dict, pipe=None) -> Dict:
    """This rank's report under ``<out>/_ranks/rank<i>.json``:
    ``describe()``, the process's kernel launches and foreign imports
    (``process_report``, taken at the stage's end) and its clock
    readings (``times``).  With ``pipe`` (the ``--scale`` routes), each
    stage's ``SSLPipeline.stats`` (``stages``: seconds, real frames,
    launches, the difference from rank 0's checkpoint, lanes, generated
    ranges).  With a ``run`` whose strategy has a mesh, its lanes and an
    update's split (``gtc_update_split`` or ``bmuf_sync_ms``), and rank 0
    writes the final TrainState gathered to the full W (every rank takes
    part in the gather) to ``<out>/_ranks/state.pt``."""
    from repro_torch.runtime.env import describe
    info = cluster.active()
    device = torch.device(info.device)
    proc = process_report()          # the stage's launches, before the split
    rep = {**proc, "rank": info.process_index,
           "world": info.process_count, "backend": info.backend,
           "device": info.device,
           "device_name": (torch.cuda.get_device_name(device)
                           if device.type == "cuda" else None),
           "stage": args.stage, **times, "describe": describe()}
    if pipe is not None:
        rep["stages"] = pipe.stats
    d = os.path.join(args.out, "_ranks")
    os.makedirs(d, exist_ok=True)
    strategy = getattr(run, "strategy", None)
    if getattr(strategy, "mesh", None) is not None:
        state = run.state
        if args.stage == "smbr":
            split = gtc_update_split(strategy, run.loss_fn, state,
                                     run.batches, device)
        else:
            split = {"block_sync": bmuf_sync_ms(strategy, state, device)}
        rep.update(lanes=list(strategy.mesh.lanes),
                   n_workers=strategy.n_workers, split=split)
        full = _host(strategy.gather_state(state).to_dict())
        cluster.on_leader(lambda: torch.save(full, os.path.join(
            d, "state.pt")))
    with open(os.path.join(d, f"rank{info.process_index}.json"), "w") as f:
        json.dump(rep, f, indent=1, default=str)
    return rep


def main(argv=None):
    t_main = time.time()
    env = bootstrap_from_env()
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="lstm-am-7khr")
    ap.add_argument("--stage", default="all",
                    choices=["all", "baseline", "teacher", "targets",
                             "student", "smbr", "waves"])
    ap.add_argument("--trainer", default="gtc", choices=["gtc", "bmuf"])
    ap.add_argument("--scale", default="tiny", choices=["tiny", "small"])
    ap.add_argument("--device", default=None,
                    help="cuda (default; REPRO_PLATFORM=cpu|gpu sets it) "
                         "or cpu")
    ap.add_argument("--full", action="store_true",
                    help="one stand-alone stage at the published width")
    ap.add_argument("--smoke", action="store_true",
                    help="LLM-arch reduced-config smoke run (any --arch "
                         "other than lstm-am-7khr runs it too)")
    ap.add_argument("--seed", type=int, default=None,
                    help="--full or --smoke: the random weights' (and "
                         "--full's data's) seed (default 0)")
    ap.add_argument("--steps", type=int, default=None,
                    help="--full --stage student: stop after this many "
                         "updates (default 0: the whole schedule); "
                         "--smoke: CE steps (default 4)")
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
                    help="this process as rank i of N: 'host:port,N,i' or "
                         "'env' (REPRO_COORDINATOR / REPRO_NUM_PROCESSES / "
                         "REPRO_PROCESS_ID; backend REPRO_DIST_BACKEND); "
                         "every --stage at --scale, or --full --stage smbr "
                         "or student --trainer bmuf, across ranks")
    ap.add_argument("--out", default="experiments/train_torch")
    args = ap.parse_args(argv)
    args.device = args.device or env.device or "cuda"
    if args.arch != "lstm-am-7khr" or args.smoke:
        print(f"[train] LLM smoke: {args.arch} on {args.device}")
        losses = train_llm_smoke(args.arch, steps=args.steps or 4,
                                 device=args.device, seed=args.seed or 0)
        print(f"[train] done, final loss {losses[-1]:.4f}")
        return {"arch": args.arch, "losses": losses}
    if not args.full:
        if args.seed is not None or args.steps is not None:
            raise ValueError("--seed and --steps apply to --full; the "
                             "pipeline runs PipelineConfig's seed and "
                             "schedule at --scale")
    elif args.stage in ("all", "waves"):
        raise ValueError("--full runs one stage at the published width; "
                         "the pipeline end to end runs at --scale "
                         "tiny|small, as do its waves (drop --full)")
    times = {"t_main": t_main}
    if args.cluster:
        ccfg = cluster.ClusterConfig.from_spec(args.cluster)
        ccfg.validate()
        why = _cluster_refusal(args) if ccfg.num_processes > 1 else None
        if why:
            raise NotImplementedError(
                f"{why} across {ccfg.num_processes} processes: the --full "
                "routes are the port's own, and the reference's launcher "
                "has no --full to run across ranks; under --cluster run "
                "the stages at --scale, or --full --stage smbr or --stage "
                "student --trainer bmuf")
        info = cluster.initialize(ccfg, device=args.device)
        times["t_initialized"] = time.time()
        print(f"[train] cluster: process {info.process_index}/"
              f"{info.process_count}"
              f"{' (coordinator)' if info.is_coordinator else ''}"
              + (f", {info.backend} on {info.device}" if info.initialized
                 else ""), flush=True)
        if info.initialized:
            args.device = info.device
            from repro_torch.runtime.env import describe
            print("[train] describe: " + json.dumps(describe()), flush=True)
    results, run, pipe = _run(args)
    info = cluster.active()
    if info is not None and info.initialized:
        times["t_done"] = time.time()
        rank_report(args, run, times, pipe)
    return results


def _run(args):
    """The stage ``args`` name -> (results, its run or None, the
    pipeline or None)."""
    info = cluster.active()
    if not args.full:
        pipe = make_pipeline(args)
        results = run_pipeline(args, pipe)
        if args.stage == "smbr" and info is not None and info.initialized:
            run = pipe.fits["smbr"]
            return results, SeqRun(
                results, run.state, run.loss_fns["smbr"], None,
                pipe._batches(pipe.rng_labeled, chunked=False,
                              uniform_len=pipe.pc.gtc_workers > 1),
                run.trainer.strategy), pipe
        return results, None, pipe
    pc = PipelineConfig()
    prefetch = pc.prefetch if args.prefetch is None else args.prefetch
    common = dict(full=True, device=args.device, seed=args.seed or 0,
                  out=args.out)
    if args.stage == "targets":
        workers = pc.gen_workers if args.gen_workers is None \
            else args.gen_workers
        return stage_targets(workers=workers, procs=args.gen_procs,
                             **common), None, None
    if args.stage == "baseline":
        return stage_baseline(prefetch=prefetch, **common).results, None, \
            None
    if args.stage == "teacher":
        return stage_teacher(prefetch=prefetch, **common).results, None, \
            None
    if args.stage == "smbr":
        workers = pc.gtc_workers if args.gtc_workers is None \
            else args.gtc_workers
        run = stage_smbr(trainer=args.trainer, gtc_workers=workers,
                         prefetch=prefetch, **common)
        return run.results, run, None
    run = stage_student(steps=args.steps or 0, trainer=args.trainer,
                        prefetch=prefetch, **common)
    return run.results, run, None


if __name__ == "__main__":
    main()
