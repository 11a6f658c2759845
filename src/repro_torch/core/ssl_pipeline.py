"""End-to-end SSL pipeline — the paper's recipe, laptop-scaled, on the card.

The twin of the reference's ``core/ssl_pipeline.py`` under the same
public names.  Stages (paper sections in brackets):
  baseline : student-architecture LSTM AM, CE on labeled data [§2]
  teacher  : bidirectional LSTM AM, CE (+ sMBR) on labeled data [§3.2]
  targets  : teacher inference over the unlabeled firehose -> top-k
             logits into the manifest-backed LogitStore v2, partitioned
             across gen_workers ledgered shard ranges [§3.2.2] (the
             ``topk_logits`` kernel on the card); resumable (work ledger)
             and wave-versioned (re-runs supersede atomically)
  student  : scheduled learning over unlabeled sub-epochs with labeled
             interleaves [§3.3], GTC or BMUF trainer [§3.5] (the
             ``sparse_ce`` kernel in the distill loss; ``gtc_compress``
             on every gradient leaf under GTC)
  smbr     : sequence training on labeled data only [§3.4], under
             threshold-compressed SGD (``gtc_compress`` on each worker)

Every training stage is one ``Trainer.fit()`` call (``repro_torch.train``)
with periodic TrainState checkpoints under ``<out>/ckpt_<stage>/state``
(a killed stage resumes mid-stream) and the prefetching feed at depth
``PipelineConfig.prefetch``.  Final params land in ``<out>/ckpt_<stage>``
— the cross-stage interface, in the reference's file format, so either
package reads the other's checkpoints and store.

Metrics include the frame error rate (FER) on a held-out synthetic VAL
set and the relative FER reduction vs the baseline, the container-scale
proxy for the paper's relative WERR.  Besides each stage's result dict
(the reference's keys), ``SSLPipeline.stats`` records each stage's
seconds, the seconds in its ``Trainer.fit`` calls or generation pass,
the real frames (mask sums) those trained on or generated (and whether
they are summed over the ranks), each kernel's launches in this process
and this rank's difference from rank 0's checkpoint, and
``SSLPipeline.fits`` each ``Trainer.fit`` call (``FitRun``: the final
TrainState, the loss functions, the per-update metrics, where it resumed,
its seconds, frames and batches).

Generation in OS processes (``gen_procs`` >= 1) spawns that many
workers through ``runtime/workers.py``; each rebuilds its engine from the
checkpoint on disk (``pipeline_teacher_engine`` /
``pipeline_student_engine``, on the pipeline's device) under a
``Supervisor`` given ``SSLPipeline(supervisor_opts=...)`` (None: its
defaults, a 120 s wave and a 3 s heartbeat timeout).  The elastic
student fit (``stage_student(membership=...)``) and the continuous waves
(``run_waves``) resize the BMUF student at block boundaries.

Across processes (``runtime.cluster.initialize`` with N > 1 ranks, each
on its own device) every stage and ``run("all")`` run in every rank, as
the reference's processes each run them, and the ranks leave the
checkpoints, store and results of one process:

* a stage with a worker axis puts its lanes on the ranks: ``stage_smbr``
  runs ``GTCShardMap`` on ``worker_mesh(gtc_workers)``, the BMUF student
  ``BMUFShardMap`` on ``worker_mesh(bmuf_workers)``; their real frames
  are summed over the ranks;
* ``stage_targets`` splits the ledger's ranges over the ranks
  (``pipeline/generate.py:generate_across_ranks``: rank 0 picks the
  wave, each rank claims ranges with its own engine and commits through
  the store's locked manifest); its frames are summed over the ranks;
* a stage without one (the baseline's and the teacher's fits, the GTC
  student at one worker) runs replicated in every rank, and its frames
  are one rank's.

Rank 0 writes every ``ckpt_<stage>`` while the others wait, and every
rank then reloads it, so each stage starts, and computes its val FER,
from rank 0's bits; ``stats[stage]["diff_from_rank0"]`` is this rank's
largest difference from them.  Generation in processes (``gen_procs``)
runs a Supervisor of that many worker processes in every rank, all of
them racing the one ledger.  The elastic student (``membership=``) and
``run_waves`` run across the ranks with the membership on rank 0 alone:
it polls the roster at each block and broadcasts the live count, and
every rank resizes its ``BMUFShardMap`` to that W (``Trainer.fit``).

Differences from the reference: the stages' behaviour across ranks
(above; the reference's processes each run every stage whole).  Initial
weights are drawn from ``torch.Generator`` seeds (``_init_params``), not
JAX's threefry.  ``stage_targets`` in processes adds the workers' exit
reports (``workers``: device, shards, kernel launches).
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointStore, load_params
from repro_torch.configs.base import LayerSpec, Segment
from repro_torch.configs.lstm_am_7khr import CONFIG as AM_CONFIG
from repro_torch.core import scheduled
from repro_torch.core.teacher import TeacherRunner
from repro_torch.data import CorpusLoader, FeatureConfig, SynthConfig
from repro_torch.distributed.bmuf import BMUFConfig
from repro_torch.distributed.gtc import GTCConfig
from repro_torch.kernels._dispatch import resolve_device
from repro_torch.launch.steps import _tensor, make_loss_fn, model_forward
from repro_torch.models import build_model
from repro_torch.pipeline import WorkLedger, generate_sharded
from repro_torch.pipeline.generate import generate_across_ranks
from repro_torch.runtime import cluster
from repro_torch.runtime.workers import (LaneCrashPlan, TrainerMembership,
                                         engine_from_checkpoint,
                                         kernel_launches)
from repro_torch.seqtrain import build_denominator_graph, make_smbr_loss_fn
from repro_torch.seqtrain.smbr import frame_error_rate
from repro_torch.store import (LogitStoreV2, full_bytes_per_frame,
                               storage_bytes_per_frame)
from repro_torch.train import (GTC, BMUFShardMap, BMUFVmap, GTCShardMap,
                               ListSink, Local, TrainBatch, Trainer,
                               TrainState, chain, distill_shard_source,
                               epoch_source, scheduled_source)
from repro_torch.train.strategies import call_loss


def am_configs(*, n_layers: int, lstm_hidden: int, n_senones: int,
               feat_dim: int):
    """(student, teacher) ModelConfigs from the pipeline's scale knobs."""
    base = AM_CONFIG.replace(
        segments=(Segment((LayerSpec(mixer="lstm", ffn="none"),),
                          repeat=n_layers),),
        lstm_hidden=lstm_hidden, n_senones=n_senones,
        vocab_size=n_senones, feat_dim=feat_dim)
    teacher = base.replace(
        name="teacher",
        segments=(Segment((LayerSpec(mixer="bilstm", ffn="none"),),
                          repeat=n_layers),))
    return base, teacher


def _engine_cfgs(kwargs: dict):
    """(student, teacher) configs from a factory's kwargs: the
    :func:`am_configs` scalars."""
    return am_configs(n_layers=int(kwargs["n_layers"]),
                      lstm_hidden=int(kwargs["lstm_hidden"]),
                      n_senones=int(kwargs["n_senones"]),
                      feat_dim=int(kwargs["feat_dim"]))


def pipeline_teacher_engine(worker_id: int, kwargs: dict):
    """Engine factory spec ``repro_torch.core.ssl_pipeline:
    pipeline_teacher_engine``: a generation worker process rebuilds the
    pipeline's TeacherRunner from the teacher checkpoint on disk (kwargs:
    ``ckpt_dir``, the :func:`am_configs` scalars, ``topk`` and
    ``device``, default ``"cuda"``)."""
    del worker_id
    _, teacher_cfg = _engine_cfgs(kwargs)
    return engine_from_checkpoint(teacher_cfg, kwargs["ckpt_dir"],
                                  int(kwargs["topk"]),
                                  kwargs.get("device", "cuda"))


def pipeline_student_engine(worker_id: int, kwargs: dict):
    """Engine factory spec ``repro_torch.core.ssl_pipeline:
    pipeline_student_engine``: the *promoted student* as the generation
    engine (iterative distillation: after a wave of scheduled learning
    the student regenerates the next wave's targets).  The teacher
    factory's kwargs; the rebuilt config is the unidirectional student."""
    del worker_id
    student_cfg, _ = _engine_cfgs(kwargs)
    return engine_from_checkpoint(student_cfg, kwargs["ckpt_dir"],
                                  int(kwargs["topk"]),
                                  kwargs.get("device", "cuda"))


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


def pad_to_longest(batches: List[dict]) -> List[dict]:
    """Every full-seq batch padded to the longest: multi-microbatch
    strategies (GTCShardMap consumes one batch per worker) group
    shape-mates, so ragged full-seq batches would drop partial groups at
    every length boundary."""
    if not batches:
        return batches
    t = max(b["feats"].shape[1] for b in batches)
    return [_pad_time(b, t) for b in batches]


def ce_source(loader: CorpusLoader, labeled, *, batch: int, chunk_len: int,
              n_epochs: int, lr: float, seed0: int = 0):
    """The supervised recipe over the utterance ids ``labeled`` = (start,
    count): chunked-BPTT epochs with rotating feature offsets (``ep %
    3``, the chunk shuffle seeded ``seed0 + ep``), then one
    full-sequence fine-tune epoch at ``lr * 0.3``."""
    start, count = labeled
    return chain(
        epoch_source(
            lambda ep: list(loader.chunked_batches(
                start, count, batch_size=batch, chunk_len=chunk_len,
                offset=ep % 3, seed=seed0 + ep)),
            n_epochs, lr, "ce"),
        epoch_source(
            lambda ep: list(loader.full_seq_batches(
                start, count, batch_size=max(2, batch // 2))),
            1, lr * 0.3, "ce"))


def first_val_batch(loader: CorpusLoader, held_out, batch: int) -> dict:
    """The first full-sequence batch of the held-out ids ``held_out`` =
    (start, count): the validation batch of the FER."""
    return next(loader.full_seq_batches(*held_out,
                                        batch_size=max(2, batch // 2)))


def val_fer(model, cfg, params, batch: dict) -> float:
    """Frame error rate of ``params`` on ``batch``: the forward without
    lens, argmax per frame, masked."""
    w = model.unembed_matrix(params)
    with torch.no_grad():
        h, _ = model_forward(model, cfg, params,
                             {"feats": _tensor(batch["feats"], w.device,
                                               torch.float32)})
        return float(frame_error_rate((h @ w).float(), batch["labels"],
                                      batch["mask"]))


def denominator_graph(pairs, n_senones: int):
    """The sMBR denominator graph from the labeled alignments (``pairs``:
    the loader's ``featurized`` list)."""
    return build_denominator_graph([lab for _, lab, _ in pairs], n_senones)


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Fed:
    """A training source that counts the batches it yields and adds up
    the seconds spent inside it (synthesis, featurization, batching; on
    the feed's thread when prefetching)."""

    def __init__(self, source):
        self.source = iter(source)
        self.batches = 0
        self.seconds = 0.0

    def __iter__(self):
        while True:
            t = time.perf_counter()
            tb = next(self.source, None)
            self.seconds += time.perf_counter() - t
            if tb is None:
                return
            self.batches += 1
            yield tb


@dataclass
class FitRun:
    """One ``Trainer.fit`` call of a stage: the Trainer, its final
    TrainState, its loss functions, its per-update metrics, the update
    it resumed at (None: a fresh start), the fit's seconds to the
    device's end, the real frames (mask sums) its loss calls trained on,
    the batches the source yielded and the seconds spent inside it."""
    trainer: Trainer
    state: TrainState
    loss_fns: Dict
    sink: ListSink
    resumed_at: Optional[int]
    fit_s: float
    frames: float
    batches: int
    source_s: float
    frames_summed: bool = False       # frames over the ranks' lanes


@dataclass
class PipelineConfig:
    # data
    n_labeled: int = 48
    n_unlabeled: int = 192
    n_val: int = 16
    n_speakers: int = 16
    n_senones: int = 49
    mean_utt_sec: float = 1.2
    n_mels: int = 16
    # model
    n_layers: int = 2
    lstm_hidden: int = 64
    # training
    batch: int = 8
    chunk_len: int = 32
    epochs_baseline: int = 5
    lr: float = 5e-2
    topk: int = 10
    ckpt_every: int = 20              # TrainState resume-ckpt cadence
    # data plane
    gen_workers: int = 2              # target-generation workers (ledgered
                                      # disjoint shard ranges, engine each)
    gen_procs: int = 0                # >0: generation in OS processes
                                      # (engines rebuilt from checkpoints)
    prefetch: int = 2                 # async feed depth for Trainer.fit
                                      # (0 = synchronous)
    # schedule (paper-structured, scaled)
    n_sub_epochs: int = 4
    labeled_every: int = 2
    chunked_until: int = 3
    # trainers
    gtc_tau: float = 2e-4
    gtc_workers: int = 2              # sMBR sequence-training workers:
                                      # >1 runs GTCShardMap (int8 wire,
                                      # on worker_mesh(W): the fleet's
                                      # ranks, or one device's loop), 1 the
                                      # single-process GTC strategy
    bmuf_workers: int = 4
    bmuf_block_steps: int = 2
    smbr_epochs: int = 2
    smbr_kappa: float = 0.3
    smbr_lr: float = 5e-3
    seed: int = 0

    @classmethod
    def tiny(cls) -> "PipelineConfig":
        return cls()

    @classmethod
    def small(cls) -> "PipelineConfig":
        return cls(n_labeled=128, n_unlabeled=640, n_val=32, n_speakers=32,
                   n_senones=97, lstm_hidden=128, n_layers=3,
                   epochs_baseline=4, n_sub_epochs=6, labeled_every=2,
                   chunked_until=4)

    @property
    def feat_dim(self) -> int:
        return self.n_mels * 3


class SSLPipeline:
    def __init__(self, pc: PipelineConfig, *,
                 out_dir: str = "experiments/train_torch",
                 student_trainer: str = "gtc", device="cuda",
                 supervisor_opts: Optional[dict] = None):
        self.device = resolve_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.pc = pc
        self.out = out_dir
        self.student_trainer = student_trainer
        self.supervisor_opts = supervisor_opts
        os.makedirs(out_dir, exist_ok=True)

        self.synth = SynthConfig(n_speakers=pc.n_speakers,
                                 n_senones=pc.n_senones,
                                 mean_utt_sec=pc.mean_utt_sec, seed=pc.seed)
        self.feat = FeatureConfig(n_mels=pc.n_mels)
        # look-ahead 0 at laptop scale, as the reference
        self.loader = CorpusLoader(synth=self.synth, feat=self.feat,
                                   lookahead=0)
        self.loader.estimate_mvn(min(24, pc.n_labeled))

        self.student_cfg, self.teacher_cfg = am_configs(
            n_layers=pc.n_layers, lstm_hidden=pc.lstm_hidden,
            n_senones=pc.n_senones, feat_dim=pc.feat_dim)

        # utterance-id ranges: labeled / unlabeled / val are disjoint
        self.rng_labeled = (0, pc.n_labeled)
        self.rng_unlabeled = (10_000, pc.n_unlabeled)
        self.rng_val = (100_000, pc.n_val)
        self._val_batch = None
        # stage -> {"seconds", "fit_s", "frames"[, "source_s"]}; frames
        # are the real frames the stage's updates trained on (or its pass
        # generated), source_s the fits' seconds inside their sources
        self.stats: Dict[str, dict] = {}
        self.fits: Dict[str, FitRun] = {}      # Trainer stage -> its fit
        self._frames: Dict[str, list] = {}

    # ------------------------------------------------------------- helpers

    def _batches(self, rng, *, chunked: bool, offset: int = 0, seed: int = 0,
                 uniform_len: bool = False):
        start, count = rng
        if chunked:
            return list(self.loader.chunked_batches(
                start, count, batch_size=self.pc.batch,
                chunk_len=self.pc.chunk_len, offset=offset, seed=seed))
        bs = list(self.loader.full_seq_batches(
            start, count, batch_size=max(2, self.pc.batch // 2),
            offset=offset))
        return pad_to_longest(bs) if uniform_len else bs

    def val_batch(self):
        if self._val_batch is None:
            self._val_batch = first_val_batch(self.loader, self.rng_val,
                                              self.pc.batch)
        return self._val_batch

    def fer(self, cfg, params) -> float:
        model = build_model(cfg, device=self.device, params=params)
        return val_fer(model, cfg, None, self.val_batch())

    def _ckpt(self, stage) -> CheckpointStore:
        return CheckpointStore(os.path.join(self.out, f"ckpt_{stage}"))

    def _init_params(self, cfg, seed: int):
        """A stage's initial weights: ``cfg``'s model drawn from ``seed``
        (the parity tests substitute the reference's init here)."""
        return build_model(cfg, device=self.device,
                           generator=torch.Generator().manual_seed(seed)
                           ).state_dict()

    def _counted(self, stage, loss_fn):
        """``loss_fn`` that also keeps its batch's real frames (the
        mask's sum, left where the mask lies) for ``fits[stage]``."""
        parts = self._frames.setdefault(stage, [])

        def fn(params, batch, rng=None):
            parts.append(torch.as_tensor(batch["mask"]).sum())
            return call_loss(loss_fn, params, batch, rng)
        return fn

    def _fit(self, stage, strategy, loss_fns, params, seed: int,
             source, membership=None) -> FitRun:
        """One Trainer per stage (resume state under
        ckpt_<stage>/state), fit from ``params`` over ``source`` (elastic
        under ``membership``), timed to the device's end; the run also
        lands in ``fits[stage]``.  The caller finalizes (retires the
        resume state) once its stage is done."""
        sink = ListSink()
        store = CheckpointStore(
            os.path.join(self.out, f"ckpt_{stage}", "state"))
        tr = Trainer(strategy,
                     {k: self._counted(stage, fn)
                      for k, fn in loss_fns.items()},
                     checkpoint=store, ckpt_every=self.pc.ckpt_every,
                     metrics=sink, prefetch=self.pc.prefetch)
        resumed_at = store.latest()
        state = tr.init_state(params, seed=seed)
        fed = _Fed(source)
        t0 = time.perf_counter()
        state = tr.fit(state, fed, membership=membership)
        _sync(self.device)
        fit_s = time.perf_counter() - t0
        frames = sum(float(x) for x in self._frames.pop(stage, []))
        # a mesh across ranks: each rank's loss calls are its lanes'
        summed = cluster.world_size() > 1 and getattr(
            getattr(strategy, "mesh", None), "distributed", False)
        if summed:
            frames = cluster.host_sum(frames)
        run = FitRun(tr, state, loss_fns, sink, resumed_at, fit_s, frames,
                     fed.batches, fed.seconds, summed)
        self.fits[stage] = run
        return run

    @staticmethod
    def _start():
        """A stage's start: the clock and each kernel's launches."""
        return time.perf_counter(), kernel_launches()

    def _record(self, stage, start, *runs: FitRun, diff: float = 0.0):
        """``stats[stage]`` from the stage's ``_start()``, its fits and
        this rank's difference ``diff`` from rank 0's checkpoint; under a
        fleet, a mesh's lanes on this rank."""
        t0, l0 = start
        self.stats[stage] = {
            "seconds": time.perf_counter() - t0,
            "fit_s": sum(r.fit_s for r in runs),
            "frames": sum(r.frames for r in runs),
            "source_s": sum(r.source_s for r in runs),
            "frames_summed_over_ranks": any(r.frames_summed for r in runs),
            "launches": {k: n - l0[k] for k, n in kernel_launches().items()
                         if n - l0[k]},
            "diff_from_rank0": diff}
        for r in runs:
            if r.frames_summed:
                self.stats[stage]["lanes"] = list(
                    r.trainer.strategy.mesh.lanes)

    def _publish(self, stage: str, cfg, params, meta=None):
        """Rank 0 writes ``ckpt_<stage>`` while the other ranks wait;
        under a fleet every rank then reloads it, so what follows starts
        from rank 0's bits.  -> (the checkpoint's params, this rank's
        largest difference from them)."""
        cluster.on_leader(lambda: self._ckpt(stage).save(0, params,
                                                         meta=meta))
        if cluster.world_size() == 1:
            return params, 0.0
        rank0 = self._load_or_none(stage, cfg)
        return rank0, max(float((params[n] - rank0[n]).abs().max())
                          for n in rank0)

    def _store(self) -> LogitStoreV2:
        """The pipeline's logit store.  Under a fleet rank 0 opens it
        first (with the gc on open) while the others wait, then every
        rank opens it in the shared mode (locked manifest commits, no
        gc): no rank sweeps a file another reads."""
        root = os.path.join(self.out, "logit_store")
        kw = dict(k=self.pc.topk, vocab=self.pc.n_senones)
        if cluster.world_size() == 1:
            return LogitStoreV2(root, **kw)
        cluster.on_leader(lambda: LogitStoreV2(root, **kw))
        return LogitStoreV2(root, shared=True, **kw)

    def _load_or_none(self, stage, cfg):
        return load_params(cfg, os.path.join(self.out, f"ckpt_{stage}"),
                           self.device)

    def _ce_source(self, *, n_epochs, lr, seed0=0):
        """The supervised recipe: chunked-BPTT epochs with rotating
        feature offsets, then one full-sequence fine-tune epoch."""
        return ce_source(self.loader, self.rng_labeled, batch=self.pc.batch,
                         chunk_len=self.pc.chunk_len, n_epochs=n_epochs,
                         lr=lr, seed0=seed0)

    def _smbr_source(self, n_epochs: int, *, uniform_len: bool = False):
        """``n_epochs`` passes over the labeled full-sequence batches at
        ``smbr_lr`` under the "smbr" loss."""
        return epoch_source(
            lambda ep: self._batches(self.rng_labeled, chunked=False,
                                     uniform_len=uniform_len),
            n_epochs, self.pc.smbr_lr, "smbr")

    # -------------------------------------------------------------- stages

    def stage_baseline(self) -> Dict:
        pc = self.pc
        start = self._start()
        init = self._init_params(self.student_cfg, pc.seed)
        model = build_model(self.student_cfg, device=self.device, params=init)
        run = self._fit("baseline", Local(),
                        {"ce": make_loss_fn(model, self.student_cfg, "ce")},
                        init, pc.seed,
                        self._ce_source(n_epochs=pc.epochs_baseline,
                                        lr=pc.lr))
        run.trainer.finalize(run.state)
        params, diff = self._publish("baseline", self.student_cfg,
                                     run.state.params)
        out = {"loss_first": run.sink.first("loss"),
               "loss_last": run.sink.last("loss"),
               "val_fer": self.fer(self.student_cfg, params)}
        self._record("baseline", start, run, diff=diff)
        return out

    def stage_teacher(self) -> Dict:
        pc = self.pc
        start = self._start()
        init = self._init_params(self.teacher_cfg, pc.seed + 1)
        model = build_model(self.teacher_cfg, device=self.device, params=init)
        ce = self._fit("teacher", Local(),
                       {"ce": make_loss_fn(model, self.teacher_cfg, "ce")},
                       init, pc.seed + 1,
                       self._ce_source(n_epochs=pc.epochs_baseline,
                                       lr=pc.lr, seed0=100))

        # sMBR fine-tune of the teacher (the paper's "with sMBR teacher"
        # arm); no grad clip: sMBR grads are bounded by the posteriors
        sm = self._fit("teacher_smbr", Local(clip=0.0),
                       {"smbr": make_smbr_loss_fn(model, self.teacher_cfg,
                                                  self._graph(),
                                                  kappa=pc.smbr_kappa)},
                       ce.state.params, pc.seed + 1, self._smbr_source(1))
        # retire resume state only once the whole stage is done: a kill
        # during the sMBR sub-fit must resume (not retrain) the CE part
        ce.trainer.finalize(ce.state)
        sm.trainer.finalize(sm.state)
        params, diff = self._publish(
            "teacher", self.teacher_cfg, sm.state.params,
            meta={"teacher": "trained (--stage teacher)"})
        out = {"loss_last": ce.sink.last("loss"),
               "val_fer": self.fer(self.teacher_cfg, params),
               "smbr_eacc": sm.sink.last("expected_frame_acc")}
        self._record("teacher", start, ce, sm, diff=diff)
        return out

    def _graph(self):
        return denominator_graph(self.loader.featurized(*self.rng_labeled),
                                 self.pc.n_senones)

    def stage_targets(self, *, promoted_stage: str = None) -> Dict:
        """Sharded generation through the data plane: the unlabeled
        corpus is partitioned across ``gen_workers`` ledgered shard
        ranges, one TeacherRunner (engine) per worker, into the
        manifest-backed LogitStore v2 — a killed run re-claims its
        unfinished ranges, a completed re-run supersedes the previous
        wave atomically.  ``promoted_stage`` switches the engine from
        the bidirectional teacher to that stage's *student* checkpoint
        (iterative distillation).  ``gen_procs`` >= 1 runs the ranges in
        that many OS processes, each rebuilding the engine from the
        checkpoint on disk; the report adds the fleet's ``processes``,
        ``restarts``, ``reclaimed``, ``n_steals``, ``events`` and the
        workers' exit reports.  Under a fleet of ranks the ranges are
        split over the ranks (``generate_across_ranks``), each with its
        own engine on its own device (with ``gen_procs``, each rank's
        worker processes on that rank's device), and
        ``stats["targets"]`` adds this rank's ``ranges`` and every
        rank's (``ranks``)."""
        pc = self.pc
        fleet = cluster.world_size() > 1
        start = self._start()
        if promoted_stage is None:
            gen_cfg, ckpt_name = self.teacher_cfg, "teacher"
            factory = "pipeline_teacher_engine"
        else:
            gen_cfg, ckpt_name = self.student_cfg, promoted_stage
            factory = "pipeline_student_engine"
        gparams = self._load_or_none(ckpt_name, gen_cfg)
        if gparams is None:
            raise FileNotFoundError(f"no checkpoint under {self.out}/"
                                    f"ckpt_{ckpt_name}: run stage "
                                    f"{ckpt_name} first")
        store = self._store()
        # host (numpy) batches: the engine moves one batch at a time, so
        # device memory stays O(1 batch) over the whole corpus
        batches = [{"feats": b["feats"], "mask": b["mask"]}
                   for b in self._batches(self.rng_unlabeled, chunked=True,
                                          seed=7)]

        if pc.gen_procs >= 1:
            # real OS processes: each rebuilds the engine from the
            # checkpoint (the factory spec crosses the process boundary;
            # params cannot) -- manifest bitwise the in-process one's
            make_engine = f"repro_torch.core.ssl_pipeline:{factory}"
            engine_kwargs = {
                "ckpt_dir": os.path.join(self.out, f"ckpt_{ckpt_name}"),
                "n_layers": pc.n_layers, "lstm_hidden": pc.lstm_hidden,
                "n_senones": pc.n_senones, "feat_dim": pc.feat_dim,
                "topk": pc.topk, "device": str(self.device)}
        else:
            engine_kwargs = None

            def make_engine(worker: int):
                return TeacherRunner(gen_cfg, gparams, k=pc.topk,
                                     device=self.device)

        t1 = time.perf_counter()
        ledger_path = os.path.join(self.out, "gen_ledger.json")
        if fleet:
            report = generate_across_ranks(
                make_engine, batches, store, n_workers=pc.gen_workers,
                ledger_path=ledger_path, processes=pc.gen_procs,
                engine_kwargs=engine_kwargs,
                supervisor_opts=self.supervisor_opts)
        else:
            report = generate_sharded(
                make_engine, batches, store, n_workers=pc.gen_workers,
                ledger_path=ledger_path, processes=pc.gen_procs,
                engine_kwargs=engine_kwargs,
                supervisor_opts=self.supervisor_opts)
        _sync(self.device)
        gen_s = time.perf_counter() - t1
        # manifest-checksum every shard (rank 0's, under a fleet)
        cluster.on_leader(store.verify)
        meta = store.stats()
        full = meta.n_frames * full_bytes_per_frame(pc.n_senones)
        packed = meta.n_frames * storage_bytes_per_frame(pc.topk)
        self._record("targets", start)
        self.stats["targets"].update(
            fit_s=gen_s, frames=float(report["frames_written"]),
            frames_summed_over_ranks=fleet)
        if fleet:
            self.stats["targets"].update(ranges=report["ranges"],
                                         ranks=report["ranks"])
        out = {"n_shards": report["n_shards"], "n_frames": meta.n_frames,
               "n_workers": report["n_workers"], "wave": report["wave"],
               "resumed": report["resumed"],
               "storage_compression_x": round(full / packed, 1)}
        if pc.gen_procs >= 1:             # the fleet's completion report
            out.update({k: report[k] for k in ("processes", "restarts",
                                               "reclaimed", "workers")})
            # structured steal/lifecycle events from the supervisor and
            # the ledger: who stole what from whom, by which signal
            events = report.get("events", [])
            out["n_steals"] = sum(e.get("event") == "steal"
                                  for e in events)
            out["events"] = events[-20:]
        return out

    def _student_strategy(self):
        """GTC at one worker (replicated under a fleet), or BMUF:
        ``BMUFShardMap`` on ``worker_mesh(bmuf_workers)`` under a fleet,
        each rank its lanes, else ``BMUFVmap``."""
        pc = self.pc
        if self.student_trainer == "bmuf":
            cfg = BMUFConfig(n_workers=pc.bmuf_workers,
                             block_steps=pc.bmuf_block_steps)
            if cluster.world_size() > 1:
                return BMUFShardMap(cfg, cluster.worker_mesh(cfg.n_workers))
            return BMUFVmap(cfg)
        return GTC(GTCConfig(tau=pc.gtc_tau, n_workers=1))

    def stage_student(self, *, membership=None, init_params=None,
                      stage: str = None) -> Dict:
        """Scheduled learning on unlabeled top-k targets + labeled
        passes — same loop for both trainers; only the strategy differs.
        ``membership`` (anything with ``live_count()``) makes the fit
        elastic: worker deaths shrink the BMUF block at the next block
        boundary, revivals grow it back; the report adds ``resizes`` and
        ``final_workers``, and ``stats[stage]`` each poll (``polls``: its
        W and this rank's lanes).  Under a fleet only rank 0 passes its
        membership (the other ranks None): it polls, broadcasts each
        count, and every rank's ``BMUFShardMap`` resizes to it
        (``Trainer.fit``).
        ``init_params``/``stage`` chain waves (each wave trains from the
        previous wave's promoted params under its own checkpoint
        stage)."""
        pc = self.pc
        start = self._start()
        baseline = (init_params if init_params is not None
                    else self._load_or_none("baseline", self.student_cfg))
        if baseline is None:
            raise FileNotFoundError(f"no checkpoint under {self.out}/"
                                    "ckpt_baseline: run stage baseline "
                                    "first")
        # the workers=1 consumer of whatever N workers generated: the
        # manifest is the contract — verify() checksums every live shard
        store = self._store()
        unl_batches = self._batches(self.rng_unlabeled, chunked=True, seed=7)
        if len(store.shards()) != len(unl_batches):
            raise ValueError(f"the store holds {len(store.shards())} "
                             f"shards for {len(unl_batches)} unlabeled "
                             "batches: regenerate targets")
        store.verify()
        per_sub = max(1, len(unl_batches) // pc.n_sub_epochs)
        sched = scheduled.ScheduleConfig(
            n_sub_epochs=pc.n_sub_epochs, sub_epoch_hours=1.0,
            labeled_every=pc.labeled_every, chunked_until=pc.chunked_until,
            lr0=pc.lr, labeled_lr_boost=1.5)

        stage = stage or f"student_{self.student_trainer}"
        model = build_model(self.student_cfg, device=self.device,
                            params=baseline)

        def unlabeled(phase):
            lo = (phase.sub_epoch - 1) * per_sub
            # pin_wave: each sub-epoch snapshots its shards' manifest
            # entries at start — a teacher regeneration landing a new
            # wave mid-sub-epoch cannot mix targets into this pass
            return distill_shard_source(unl_batches, store, lo,
                                        lo + per_sub, phase.lr,
                                        pin_wave=True)

        def labeled(phase):
            return (TrainBatch(b, phase.lr, "ce")
                    for b in self._batches(
                        self.rng_labeled, chunked=phase.chunked,
                        offset=max(phase.feature_offset, 0)))

        run = self._fit(
            stage, self._student_strategy(),
            {"distill_topk": make_loss_fn(model, self.student_cfg,
                                          "distill_topk"),
             "ce": make_loss_fn(model, self.student_cfg, "ce")},
            baseline, pc.seed,
            scheduled_source(sched, unlabeled=unlabeled, labeled=labeled),
            membership=membership)
        run.trainer.finalize(run.state)
        params, diff = self._publish(stage, self.student_cfg,
                                     run.state.params)
        losses = run.sink.values("loss")
        out = {"n_steps": len(losses),
               "loss_first": losses[0] if losses else None,
               "loss_last": losses[-1] if losses else None,
               **self._student_metrics(params)}
        if run.trainer.polls:           # an elastic fit (rank 0's membership)
            out["resizes"] = dict(run.trainer.resize_stats)
            out["final_workers"] = run.trainer.strategy.n_workers
        self._record(stage, start, run, diff=diff)
        if run.trainer.polls:
            self.stats[stage]["polls"] = run.trainer.polls
        return out

    def _student_metrics(self, params, base=None) -> Dict:
        """The validation FER of ``params``, the baseline's (``base``,
        else ``ckpt_baseline``'s) and the relative reduction."""
        if base is None:
            base = self._load_or_none("baseline", self.student_cfg)
        fer = self.fer(self.student_cfg, params)
        base_fer = self.fer(self.student_cfg, base)
        return {"val_fer": fer, "baseline_fer": base_fer,
                "rel_fer_reduction_pct":
                    round(100 * (base_fer - fer) / max(base_fer, 1e-9), 2)}

    def _smbr_strategy(self):
        """The paper's 16-GPU sMBR trainer: threshold-compressed SGD.
        ``gtc_workers > 1`` runs GTCShardMap on ``worker_mesh(W)``: the
        widest axis W divides onto the fleet's ranks, each rank its
        lanes (without a fleet, one rank holding all W: the reference's
        one-device mesh, the same math)."""
        pc = self.pc
        if pc.gtc_workers <= 1:
            return GTC(GTCConfig(tau=pc.gtc_tau, n_workers=1), clip=0.0)
        return GTCShardMap(
            GTCConfig(tau=pc.gtc_tau, n_workers=pc.gtc_workers),
            cluster.worker_mesh(pc.gtc_workers), clip=0.0)

    def stage_smbr(self) -> Dict:
        """Sequence training of the SSL student on labeled data only,
        under threshold-compressed SGD — the paper's sMBR trainer
        (§3.4), multi-worker by default (``gtc_workers``): each update
        consumes one batch per worker and exchanges int8-packed sends
        over the worker axis.  Starts from ``ckpt_student_<trainer>``,
        else from ``ckpt_baseline``."""
        pc = self.pc
        start = self._start()
        base = self._load_or_none("baseline", self.student_cfg)
        if base is None:
            raise FileNotFoundError(f"no checkpoint under {self.out}/"
                                    "ckpt_baseline: run stage baseline "
                                    "first")
        params = self._load_or_none(f"student_{self.student_trainer}",
                                    self.student_cfg)
        if params is None:
            params = base
        model = build_model(self.student_cfg, device=self.device,
                            params=params)
        run = self._fit(
            "smbr", self._smbr_strategy(),
            {"smbr": make_smbr_loss_fn(model, self.student_cfg,
                                       self._graph(), kappa=pc.smbr_kappa)},
            params, pc.seed,
            self._smbr_source(pc.smbr_epochs,
                              uniform_len=pc.gtc_workers > 1))
        run.trainer.finalize(run.state)
        params, diff = self._publish("smbr", self.student_cfg,
                                     run.state.params)
        out = {"eacc_first": run.sink.first("expected_frame_acc"),
               "eacc_last": run.sink.last("expected_frame_acc"),
               **self._student_metrics(params, base)}
        self._record("smbr", start, run, diff=diff)
        return out

    # ----------------------------------------------------------------- run

    def run(self, stage: str = "all") -> Dict:
        if stage != "all":
            return getattr(self, f"stage_{stage}")()
        out = {}
        for s in ("baseline", "teacher", "targets", "student", "smbr"):
            out[s] = getattr(self, f"stage_{s}")()
            print(f"[pipeline] {s}: {out[s]}")
        return out

    # ---------------------------------------------------------------- waves

    def run_waves(self, n_waves: int = 2, *, kill_at: Optional[int] = 1,
                  revive_after: Optional[int] = 2) -> Dict:
        """Continuous elastic scheduled learning: generate -> train ->
        promote, repeated, surviving injected worker deaths.

        Wave 0 distills from the bidirectional teacher; every later wave
        *regenerates* the targets with the previous wave's student
        promoted to teacher (iterative distillation) through the v2
        store's atomic wave supersede.  Each wave's BMUF student fit runs
        under a :class:`~repro_torch.runtime.workers.TrainerMembership`
        with a scripted :class:`~repro_torch.runtime.workers
        .LaneCrashPlan`: one lane is killed after block ``kill_at`` (the
        block average shrinks to the survivors at the next sync) and
        revived ``revive_after`` blocks later (warm rejoin).  Needs the
        ``bmuf`` student trainer (the only one with worker-stacked state
        to be elastic over), >= 2 lanes and a baseline.

        Returns per-wave generation and student reports plus the final
        health checks: manifest checksum-verified, superseded waves
        garbage-collected, generation ledger fully done.

        Under a fleet of ranks every rank calls it: each wave's targets
        split over the ranks (with ``gen_procs``, each rank's worker
        processes), and its student's lanes on the ranks.  Rank 0 alone
        holds the roster (``<out>/trainer_members.json``) and the crash
        plan, and every rank follows its counts; rank 0 publishes
        ``student_wave<w>``, which every rank reloads as the next wave's
        generator and init.  Every rank verifies the store; rank 0 alone
        collects the superseded waves (two ranks' gc could sweep each
        other's staged shards).  The report's ``chaos`` and ``resizes``
        are rank 0's, and each wave adds ``ranks``: every rank's
        ``ranges``, final ``lanes`` and the ``lanes`` and W of each of
        its polls (``polls``).
        """
        pc = self.pc
        if self.student_trainer != "bmuf":
            raise ValueError("elastic waves need the BMUF student trainer")
        if pc.bmuf_workers < 2:
            raise ValueError("elastic waves need >= 2 lanes to kill one")
        if self._load_or_none("baseline", self.student_cfg) is None:
            raise FileNotFoundError(f"no checkpoint under {self.out}/"
                                    "ckpt_baseline: run stage baseline "
                                    "first")
        fleet = cluster.world_size() > 1
        lead = cluster.is_leader()
        membership = TrainerMembership(
            os.path.join(self.out, "trainer_members.json"),
            timeout_s=30.0) if lead else None
        lanes = [f"lane{i}" for i in range(pc.bmuf_workers)]

        waves = []
        prev_stage = None       # None -> the bilstm teacher generates
        for w in range(n_waves):
            gen = self.stage_targets(promoted_stage=prev_stage)
            plan = None
            if lead:
                # every lane rejoins at the wave boundary (revived workers
                # come back warm; the roster is the ground truth mid-wave)
                for lane in lanes:
                    membership.join(lane)
                victim = lanes[-1 - (w % (len(lanes) - 1))]  # rotate,
                plan = LaneCrashPlan(                        # keep lane0
                    membership,
                    kills={} if kill_at is None else {kill_at: victim},
                    revives={} if kill_at is None or revive_after is None
                    else {kill_at + revive_after: victim})
            stage = f"student_wave{w}"
            init = (None if prev_stage is None
                    else self._load_or_none(prev_stage, self.student_cfg))
            rep = self.stage_student(membership=plan, init_params=init,
                                     stage=stage)
            # rank 0's chaos and resizes: the other ranks hold no plan
            rep["chaos"], rep["resizes"] = cluster.broadcast_object(
                (plan.log if lead else None, rep["resizes"]))
            wave = {"wave": gen["wave"], "gen": gen, "student": rep}
            if fleet:
                wave["ranks"] = cluster.all_gather_object({
                    "rank": cluster.active().process_index,
                    "ranges": self.stats["targets"]["ranges"],
                    "lanes": self.stats[stage]["lanes"],
                    "polls": self.stats[stage]["polls"]})
            waves.append(wave)
            print(f"[waves] wave {w}: gen wave={gen['wave']} "
                  f"fer={rep['val_fer']:.3f} resizes={rep['resizes']} "
                  f"chaos={rep['chaos']}")
            prev_stage = stage  # student promoted to teacher

        root = os.path.join(self.out, "logit_store")
        kw = dict(k=pc.topk, vocab=pc.n_senones)
        n_verified = LogitStoreV2(root, shared=fleet, **kw).verify()
        cluster.barrier()               # every rank has read the store
        # superseded waves leave no orphans: rank 0's gc alone
        removed = cluster.broadcast_object(cluster.on_leader(
            lambda: LogitStoreV2(root, **kw).gc()))
        ledger_clean = WorkLedger.peek_all_done(
            os.path.join(self.out, "gen_ledger.json"))
        return {"n_waves": n_waves, "waves": waves,
                "manifest_clean": True, "n_verified": n_verified,
                "gc_removed": len(removed), "ledger_clean": ledger_clean,
                "restarts_absorbed": sum(
                    1 for wv in waves
                    for e in wv["student"].get("chaos", [])
                    if e.get("event") == "kill"),
                "resize_count": sum(
                    wv["student"]["resizes"]["count"] for wv in waves),
                "resize_seconds": round(sum(
                    wv["student"]["resizes"]["seconds"] for wv in waves),
                    3),
                "final_fer": waves[-1]["student"]["val_fer"],
                "rel_fer_reduction_pct":
                    waves[-1]["student"]["rel_fer_reduction_pct"]}
