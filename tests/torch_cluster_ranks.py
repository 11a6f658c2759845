"""The rank program of ``tests/test_torch_cluster.py``, and its runs.

``python tests/torch_cluster_ranks.py --port P --world N --rank i --out D``
is one rank of a gloo fleet on the host: it joins the fleet through
``repro_torch.runtime.cluster.initialize`` and runs every scenario below
on ``worker_mesh(W)``, each rank its own lanes, then writes what it saw
to ``D/rank<i>.pt``.  The test process runs the same scenario functions
with ``mesh=None`` (the one-device loop) and holds the ranks to them and
to the reference.  Inputs come from numpy seeds here, and the LSTM
student's weights from ``D/weights.pt``, which the test writes.  With
``--pipeline`` a rank runs :func:`pipeline_arms` instead, the SSL
pipeline at ``PIPE`` across the ranks; with ``--waves`` it runs
:func:`waves_scenarios`: target generation in worker processes a rank,
the launcher's ``--stage targets --gen-procs 1`` and ``run_waves`` at
``WAVES``.  This module imports neither jax nor the reference: the ranks
must not.

``spawn`` starts the N ranks with one OpenMP thread each and a hard
timeout; one rank's failure kills the others and raises with every
rank's log.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.checkpoint import CheckpointStore  # noqa: E402
from repro_torch.configs.base import LayerSpec, Segment  # noqa: E402
from repro_torch.configs.lstm_am_7khr import CONFIG  # noqa: E402
from repro_torch.distributed import bmuf, gtc  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.runtime import cluster  # noqa: E402
from repro_torch.runtime.procs import child_env  # noqa: E402
from repro_torch import train  # noqa: E402
from repro_torch.train.state import cut_lanes, gather_lanes  # noqa: E402

TAU = 1e-3                      # the linear probe's threshold
LSTM_TAU = 2e-4                 # the LSTM student's (PipelineConfig's)
WIRES = {"float": dict(quantize_int8=False),
         "int8": dict(quantize_int8=True),
         "int32": dict(quantize_int8=True, int32_accum=True)}
SHAPES = {"a": (9, 5), "b": (7,)}
F, H, V, K = 12, 32, 97, 20     # the reduced student of test_torch_bmuf
B, S = 4, 8
ROUNDS = 4                      # linear-probe exchanges a case
LSTM_ROUNDS = 2                 # LSTM exchanges a case
GTC_W = (2, 3, 4)              # W = 3 on 2 ranks: rank 1 holds no lane
TIMEOUT_S = 240.0               # a spawn's hard limit


# ----------------------------------------------------------------- inputs

def student_cfg(base=CONFIG, seg=Segment, spec=LayerSpec):
    return base.replace(
        lstm_hidden=H, feat_dim=F, n_senones=V, vocab_size=V,
        segments=(seg((spec(mixer="lstm", ffn="none"),), repeat=2),))


def distill_batch(seed):
    rng = np.random.default_rng(seed)
    vals = -np.sort(-rng.normal(size=(B, S, K)) * 3, axis=-1)
    idx = np.stack([rng.permutation(V)[:K] for _ in range(B * S)])
    mask = np.ones((B, S), np.float32)
    mask[-1, S // 2:] = 0.0
    return {"feats": rng.normal(size=(B, S, F)).astype(np.float32),
            "mask": mask,
            "topk_vals": (vals - vals[..., :1]).astype(np.float32),
            "topk_idx": idx.reshape(B, S, K).astype(np.int32)}


def ce_batch(seed):
    rng = np.random.default_rng(seed)
    return {"feats": rng.normal(size=(B, S, F)).astype(np.float32),
            "labels": rng.integers(0, V, (B, S)).astype(np.int32),
            "mask": np.ones((B, S), np.float32)}


def probe_batch(seed):
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=s) * TAU).astype(np.float32)
            for k, s in SHAPES.items()}


def lin_loss(params, batch):
    """Linear probe: d loss / d w == batch[k] bitwise."""
    loss = sum(torch.sum(params[k] * torch.as_tensor(batch[k]))
               for k in sorted(params))
    return loss, {"loss": loss.detach()}


def capture(params, update, opt_state, *, lr):
    """An "optimizer" whose new params are the applied update."""
    return update, opt_state


def student(weights):
    """The reduced student's model and its CE / distill losses."""
    cfg = student_cfg()
    model = build_model(cfg, device="cpu", params=weights)
    return {k: steps.make_loss_fn(model, cfg, k)
            for k in ("ce", "distill_topk")}


def _full(tr, state):
    """``state`` W-stacked (a mesh strategy's rows gathered)."""
    gather = getattr(tr.strategy, "gather_state", None)
    return state if gather is None else gather(state)


def _stacked(batches):
    return {k: torch.stack([torch.as_tensor(b[k]) for b in batches])
            for k in batches[0]}


# -------------------------------------------------------------- scenarios

def gtc_rounds(w, wire, kind, weights, mesh=None):
    """``make_sharded_gtc_train_step`` on ``mesh`` (None: the one-device
    loop) with the capture optimizer: each round the applied update, the
    residuals gathered to W rows and the metrics.  ``kind`` "probe" is
    the linear probe from zeros, "lstm" the student's distill loss."""
    if kind == "probe":
        tau, loss, rounds = TAU, lin_loss, ROUNDS
        params = {k: torch.zeros(s) for k, s in SHAPES.items()}
        make = probe_batch
    else:
        tau, loss, rounds = LSTM_TAU, student(weights)["distill_topk"], \
            LSTM_ROUNDS
        params = weights
        make = distill_batch
    cfg = gtc.GTCConfig(tau=tau, n_workers=w, **WIRES[wire])
    step = gtc.make_sharded_gtc_train_step(loss, capture, cfg, mesh)
    state = gtc.gtc_init(params, cfg)
    if mesh is not None:
        state = cut_lanes(state, mesh)
    out = []
    for r in range(rounds):
        batches = _stacked([make(1000 * w + 100 * r + i) for i in range(w)])
        if mesh is not None:
            batches = cut_lanes(batches, mesh)
        upd, _, state, ms = step(params, None, state, batches, 0.05)
        res = state["residual"]
        out.append({"update": upd, "metrics": ms,
                    "residual": res if mesh is None
                    else gather_lanes(res, mesh)})
    return out


GTC_FIT_W = 4
GTC_FIT_UPDATES = 4


def gtc_micro(n):
    """``n`` distill microbatches for the GTCShardMap fits."""
    return [train.TrainBatch(distill_batch(5000 + i), 0.05, "distill_topk")
            for i in range(n)]


def gtc_fit(weights, mesh_of, ckpt_dir, *, resume_at=None):
    """``Trainer.fit`` under ``GTCShardMap(W=4, int8, clip 1)`` over 4
    updates, checkpointing every 2 into ``ckpt_dir``; ``resume_at``: stop
    after that many updates, then a new Trainer resumes the rest.  Then
    ``Trainer.resize`` to W = 2 and 2 more updates.  ``mesh_of(W)`` gives
    the mesh (None: the one-device loop).  -> the gathered states and the
    metrics."""
    losses = student(weights)

    def trainer():
        strat = train.GTCShardMap(
            gtc.GTCConfig(tau=LSTM_TAU, n_workers=GTC_FIT_W),
            mesh_of(GTC_FIT_W), clip=1.0)
        return train.Trainer(strat, losses, metrics=train.ListSink(),
                             checkpoint=CheckpointStore(ckpt_dir),
                             ckpt_every=2)

    micro = gtc_micro(GTC_FIT_W * GTC_FIT_UPDATES)
    tr = trainer()
    state = tr.fit(tr.init_state(weights, seed=3), micro,
                   max_updates=resume_at)
    sinks = [tr.metrics.records]
    if resume_at is not None:
        tr = trainer()
        state = tr.fit(tr.init_state(weights, seed=3), micro)
        sinks.append(tr.metrics.records)
    four = _full(tr, state)
    state = tr.resize(state, 2)
    state = tr.fit(state, [train.TrainBatch(distill_batch(7000 + i), 0.05,
                                            "distill_topk")
                           for i in range(4)], resume=False)
    return {"w4": four, "w2": _full(tr, state), "records": sinks,
            "workers": tr.strategy.n_workers}


BMUF_W, BMUF_TAU = 4, 2
ACTIVE = [1.0, 0.0, 1.0, 1.0]


def bmuf_micro():
    """A CE block, then a distill block (test_torch_bmuf's order)."""
    n = BMUF_W * BMUF_TAU
    return ([("ce", ce_batch(100 + i), 0.05) for i in range(n)]
            + [("distill_topk", distill_batch(200 + i), 0.04)
               for i in range(n)])


def bmuf_fit(weights, mesh=None):
    """Two blocks of ``Trainer.fit`` under ``BMUFShardMap`` on ``mesh``
    (None: ``BMUFVmap``), then one distill block driven by hand with the
    ``ACTIVE`` mask.  -> the gathered states and the metrics."""
    cfg = bmuf.BMUFConfig(n_workers=BMUF_W, block_steps=BMUF_TAU)
    losses = student(weights)
    strat = (train.BMUFVmap(cfg) if mesh is None
             else train.BMUFShardMap(cfg, mesh))
    sink = train.ListSink()
    tr = train.Trainer(strat, losses, metrics=sink)
    state = tr.fit(tr.init_state(weights),
                   [train.TrainBatch(b, lr, k) for k, b, lr in bmuf_micro()])
    out = {"fit": _full(tr, state), "records": sink.records}
    step = train.make_sgd_step(losses["distill_topk"])
    block = (bmuf.make_bmuf_block_step(step, cfg) if mesh is None
             else bmuf.make_sharded_bmuf_block_step(step, cfg, mesh))
    group = [distill_batch(300 + i) for i in range(BMUF_W * BMUF_TAU)]
    bstate = {"theta_g": state.params, **state.strategy_state}
    bstate, opt, ms = block(bstate, state.opt_state, strat.stack(group),
                            0.04, 11, active=ACTIVE)
    if mesh is not None:
        bstate = dict(bstate, workers=gather_lanes(bstate["workers"], mesh))
        opt = gather_lanes(opt, mesh)
    out["masked"] = {"block": bstate, "opt": opt, "metrics": ms}
    return out


def bmuf_block3(weights, mesh=None):
    """One distill block at W = 3 (tau = 2) with lane 1 masked out: on 2
    ranks rank 0 holds every lane and rank 1 none, and takes part in the
    sync with zeros.  -> the block's state (lanes gathered) and
    metrics."""
    cfg = bmuf.BMUFConfig(n_workers=3, block_steps=BMUF_TAU)
    strat = (train.BMUFVmap(cfg) if mesh is None
             else train.BMUFShardMap(cfg, mesh))
    step = train.make_sgd_step(student(weights)["distill_topk"])
    block = (bmuf.make_bmuf_block_step(step, cfg) if mesh is None
             else bmuf.make_sharded_bmuf_block_step(step, cfg, mesh))
    st = {"theta_g": weights, **strat.init_state(weights)}
    group = [distill_batch(400 + i) for i in range(3 * BMUF_TAU)]
    st, opt, ms = block(st, strat.init_opt(weights), strat.stack(group),
                        0.04, active=[1.0, 0.0, 1.0])
    if mesh is not None:
        st = dict(st, workers=gather_lanes(st["workers"], mesh))
    return {"block": st, "metrics": ms}


def student_stage(out, *, report=False):
    """The launcher's BMUF student stage at reduced widths
    (``launch.train.stage_student(full=False, trainer="bmuf")``): under a
    fleet ``BMUFShardMap`` with rank 0 writing the targets, alone
    ``BMUFVmap``.  ``report``: the rank's report and rank 0's gathered
    state under ``out/_ranks`` (``launch.train.rank_report``).  -> the
    results and the state (this rank's rows)."""
    from repro_torch.launch import train as launch_train
    run = launch_train.stage_student(full=False, trainer="bmuf",
                                     device="cpu", out=out,
                                     log=lambda _m: None)
    if report:
        launch_train.rank_report(argparse.Namespace(stage="student",
                                                    out=out), run,
                                 {"t_main": time.time()})
    return {"results": run.results, "state": run.state}


# ------------------------------------------------------------ the pipeline

# PipelineConfig smaller than tiny(): 12 labeled utterances in batches of
# 4 x 16 frames (9 chunked CE batches, 6 full-sequence), 24 unlabeled (14
# shards over gen_workers = 2 ranges), one epoch of each fit and one
# student sub-epoch; gtc_workers = 2, bmuf_workers = 4 (two BMUF blocks:
# one distill, one CE) and every other field tiny()'s
PIPE = dict(n_labeled=12, n_unlabeled=24, n_val=4, batch=4, chunk_len=16,
            epochs_baseline=1, n_sub_epochs=1, labeled_every=1,
            chunked_until=1, smbr_epochs=1)
ARM_INPUTS = ("ckpt_baseline", "ckpt_teacher", "logit_store",
              "gen_ledger.json")


def pipeline_arms(out, *, report=False):
    """The GTC arm, ``run("all")`` at ``PIPE`` through the launcher's
    ``run_pipeline`` in ``out/gtc``; then the BMUF arm in ``out/bmuf``
    from the GTC arm's baseline, teacher and targets (rank 0 copies
    them): its student and sMBR stages.  ``report``: each arm's rank
    report (``launch.train.rank_report``) under ``<arm>/_ranks``.  ->
    the results, each arm's ``stats`` and, under a fleet, what
    the waves' refusals raised (``run_waves`` on the GTC arm, and on
    the BMUF arm at one lane)."""
    import argparse
    import shutil
    from repro_torch.core.ssl_pipeline import PipelineConfig, SSLPipeline
    from repro_torch.launch import train as launch_train
    pc = PipelineConfig(**PIPE)
    t_main = time.time()
    args = argparse.Namespace(stage="all", out=os.path.join(out, "gtc"))
    gtc = SSLPipeline(pc, out_dir=args.out, device="cpu")
    res = {"gtc": launch_train.run_pipeline(args, gtc)}

    def inputs():
        for name in ARM_INPUTS:
            src, dst = os.path.join(args.out, name), os.path.join(
                out, "bmuf", name)
            if os.path.isdir(src):
                shutil.copytree(src, dst)
            else:
                shutil.copy(src, dst)
    cluster.on_leader(inputs)
    bmuf = SSLPipeline(pc, out_dir=os.path.join(out, "bmuf"),
                       student_trainer="bmuf", device="cpu")
    res["bmuf"] = {s: bmuf.run(s) for s in ("student", "smbr")}
    got = {"results": res, "stats": {"gtc": gtc.stats, "bmuf": bmuf.stats}}
    if report:
        for arm, pipe in (("gtc", gtc), ("bmuf", bmuf)):
            launch_train.rank_report(
                argparse.Namespace(stage="all", out=pipe.out), None,
                {"t_main": t_main, "t_done": time.time()}, pipe)
    if cluster.world_size() > 1:
        # the waves' own refusals, before any work, in every rank
        got["refused"] = {}
        bmuf.pc = dataclasses.replace(pc, bmuf_workers=1)
        for name, call in (("run_waves", gtc.run_waves),
                           ("lanes", bmuf.run_waves)):
            try:
                call()
            except ValueError as e:
                got["refused"][name] = str(e)
        got["members_file"] = any(os.path.exists(os.path.join(
            p.out, "trainer_members.json")) for p in (gtc, bmuf))
    return got


# ----------------------------------------------------- processes and waves

SUPERVISOR = {"timeout_s": 240.0, "heartbeat_timeout_s": 240.0}
PROBE = "repro_torch.runtime.workers:linear_probe_engine"
PROBE_KW = {"k": 4, "vocab": 11}
GEN_BATCHES, GEN_RANGES = 12, 4
CRASH = {"worker": 0, "after_shards": 1}   # every rank's worker 0 armed;
                                           # the first past it fires
# PIPE with 36 unlabeled utterances (22 shards over gen_workers = 2
# ranges): a wave's BMUF student (W = 4, tau = 2) fills a distill block
# at W = 4, two at W = 3 after lane 3's kill at poll 1 (rank 1 then
# holds no lane), drops the 2 batches left at W = 4 after the revive at
# poll 3, and one CE block: polls at W 4, 3, 3, 4, 4; each wave's
# targets in one worker process a rank
WAVES = dict(PIPE, n_unlabeled=36, gen_procs=1)


def probe_batches():
    """``GEN_BATCHES`` ragged batches for the linear-probe engine."""
    rng = np.random.default_rng(5)
    return [{"feats": rng.normal(size=(2, 5, 6)).astype(np.float32),
             "mask": (np.arange(5)[None] < [[5], [2 + i % 4]]).astype(
                 np.float32)} for i in range(GEN_BATCHES)]


def gen_procs(out, *, processes, crash=None):
    """The linear probe's targets of ``probe_batches`` into ``out/store``
    over ``GEN_RANGES`` ranges: under a fleet ``generate_across_ranks``
    with ``processes`` worker processes a rank, alone
    ``generate_sharded(processes=)``.  -> the report."""
    from repro_torch.pipeline.generate import (generate_across_ranks,
                                               generate_sharded)
    from repro_torch.store import LogitStoreV2
    root = os.path.join(out, "store")
    fleet = cluster.world_size() > 1
    cluster.on_leader(lambda: LogitStoreV2(root, **PROBE_KW))
    store = LogitStoreV2(root, shared=fleet, **PROBE_KW)
    fn = generate_across_ranks if fleet else generate_sharded
    return fn(PROBE, probe_batches(), store, n_workers=GEN_RANGES,
              ledger_path=os.path.join(out, "gen_ledger.json"),
              processes=processes, engine_kwargs=PROBE_KW, crash=crash,
              supervisor_opts=SUPERVISOR)


def waves(out):
    """``run_waves(2, kill_at=1, revive_after=2)`` at ``WAVES`` in
    ``out`` (BMUF, W = 4, tau = 2), from the baseline's and the
    teacher's initial params (rank 0 writes them).  -> the report and
    the pipeline's stats."""
    from repro_torch.core.ssl_pipeline import PipelineConfig, SSLPipeline
    pipe = SSLPipeline(PipelineConfig(**WAVES), out_dir=out,
                       student_trainer="bmuf", device="cpu",
                       supervisor_opts=SUPERVISOR)

    def inits():
        pipe._ckpt("baseline").save(0, pipe._init_params(
            pipe.student_cfg, pipe.pc.seed))
        pipe._ckpt("teacher").save(0, pipe._init_params(
            pipe.teacher_cfg, pipe.pc.seed + 1))
    cluster.on_leader(inits)
    rep = pipe.run_waves(2, kill_at=1, revive_after=2)
    return {"report": rep, "stats": pipe.stats}


def launcher_targets(out, cluster_spec=None):
    """``launch.train --stage targets --gen-procs 1 --scale tiny`` in
    ``out`` (``--cluster cluster_spec`` under a fleet), from the
    teacher's initial params; without a fleet, ``--gen-procs 0``.  ->
    the results."""
    from repro_torch.core.ssl_pipeline import PipelineConfig, SSLPipeline
    from repro_torch.launch import train as launch_train

    def teacher():
        pipe = SSLPipeline(PipelineConfig.tiny(), out_dir=out, device="cpu")
        pipe._ckpt("teacher").save(0, pipe._init_params(
            pipe.teacher_cfg, pipe.pc.seed + 1))
    cluster.on_leader(teacher)
    argv = ["--stage", "targets", "--scale", "tiny", "--device", "cpu",
            "--out", out]
    if cluster_spec:
        argv += ["--cluster", cluster_spec, "--gen-procs", "1"]
    return launch_train.main(argv)


ELASTIC_MICRO = 18      # tau = 1 distill microbatches: blocks at W 4,
                        # 3, 3, 4, 4 under the rank-0 plan below


def elastic_fit(out):
    """``Trainer.fit(membership=)`` of the reduced student, BMUF W = 4,
    tau = 1, over ``ELASTIC_MICRO`` distill microbatches: rank 0's (or
    the one process's) ``LaneCrashPlan`` kills lane3 at poll 1 and
    revives it at poll 3.  Under a fleet rank 1 passes a plan of its own,
    over another roster, that kills lane2 at poll 2: the fleet follows
    rank 0, so that plan is never polled.  -> the polls, each plan's
    poll count and log, and the gathered final state."""
    from repro_torch.runtime.workers import LaneCrashPlan, TrainerMembership
    fleet = cluster.world_size() > 1
    lead = cluster.is_leader()
    weights = build_model(student_cfg(), device="cpu",
                          generator=torch.Generator().manual_seed(0)
                          ).state_dict()
    rank = cluster.active().process_index if fleet else 0
    members = TrainerMembership(os.path.join(out, f"rank{rank}",
                                             "members.json"),
                                timeout_s=3600.0)
    for i in range(BMUF_W):
        members.join(f"lane{i}")
    plan = (LaneCrashPlan(members, kills={1: "lane3"}, revives={3: "lane3"})
            if lead else LaneCrashPlan(members, kills={2: "lane2"}))
    cfg = bmuf.BMUFConfig(n_workers=BMUF_W, block_steps=1)
    strat = (train.BMUFShardMap(cfg, cluster.worker_mesh(BMUF_W)) if fleet
             else train.BMUFVmap(cfg))
    tr = train.Trainer(strat, {"distill_topk":
                               student(weights)["distill_topk"]})
    state = tr.fit(tr.init_state(weights),
                   [train.TrainBatch(distill_batch(600 + i), 0.05,
                                     "distill_topk")
                    for i in range(ELASTIC_MICRO)], membership=plan)
    return {"polls": tr.polls, "plan_polls": plan.polls, "log": plan.log,
            "state": _cpu(_full(tr, state))}


def waves_scenarios(out, cluster_spec=None):
    """Every scenario of ``test_torch_cluster_waves.py`` in ``out``:
    ``gen`` and ``crash`` (the linear probe through worker processes;
    under a fleet one a rank, ``crash`` SIGKILLing the first worker to
    pass ``CRASH``'s ``after_shards`` mid-range; alone 2 processes and no
    crash),
    ``elastic``
    (:func:`elastic_fit`), ``waves`` and ``targets`` (the launcher)."""
    fleet = cluster.world_size() > 1
    got = {"gen": gen_procs(os.path.join(out, "gen"),
                            processes=1 if fleet else 2)}
    got["elastic"] = elastic_fit(os.path.join(out, "elastic"))
    if fleet:
        got["crash"] = gen_procs(os.path.join(out, "crash"), processes=1,
                                 crash=CRASH)
    got["waves"] = waves(os.path.join(out, "waves"))
    got["targets"] = launcher_targets(os.path.join(out, "targets"),
                                      cluster_spec)
    return got


# ------------------------------------------------------------- the ranks

def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_cpu(v) for v in tree]
    if isinstance(tree, train.TrainState):
        return _cpu(tree.to_dict())
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree)
    return tree.detach().cpu() if torch.is_tensor(tree) else tree


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--pipeline", action="store_true")
    ap.add_argument("--waves", action="store_true")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    spec = f"127.0.0.1:{args.port},{args.world},{args.rank}"
    info = cluster.initialize(cluster.ClusterConfig(
        f"127.0.0.1:{args.port}", args.world, args.rank, "gloo"),
        device="cpu")
    if args.pipeline or args.waves:
        got = (pipeline_arms(args.out, report=True) if args.pipeline
               else waves_scenarios(args.out, spec))
        torch.save(got, os.path.join(args.out, f"rank{args.rank}.pt"))
        cluster._reset_for_tests()
        return
    weights = torch.load(os.path.join(args.out, "weights.pt"))
    out = {"info": [info.process_index, info.process_count, info.device],
           "lanes": {w: cluster.worker_mesh(w).lanes
                     for w in (1, 2, 3, 4)}}
    for w in GTC_W:
        for wire in WIRES:
            for kind in ("probe", "lstm"):
                out[f"gtc/{w}/{wire}/{kind}"] = gtc_rounds(
                    w, wire, kind, weights, cluster.worker_mesh(w))
    for name, at in (("straight", None), ("killed", 2)):
        out[f"fit/{name}"] = gtc_fit(
            weights, cluster.worker_mesh,
            os.path.join(args.out, f"ckpt_{name}"), resume_at=at)
    out["bmuf"] = bmuf_fit(weights, cluster.worker_mesh(BMUF_W))
    out["bmuf3"] = bmuf_block3(weights, cluster.worker_mesh(3))
    out["student"] = student_stage(os.path.join(args.out, "student"),
                                   report=True)
    torch.save(_cpu(out), os.path.join(args.out, f"rank{args.rank}.pt"))
    cluster._reset_for_tests()


def free_port() -> int:
    """A port nothing listens on now (bound to 0, then released)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(argv_of, world: int, *, cwd, timeout: float = TIMEOUT_S,
          env=None, during=None):
    """Run ``world`` ranks, rank i ``argv_of(i)``, with one OpenMP thread
    each and gloo as the backend; call ``during()`` while they run, then
    wait for all of them up to ``timeout`` seconds from their start.  A
    rank that fails or outlives the limit (or ``during`` raising) kills
    the others and raises with every rank's output.  -> (each rank's
    output, what ``during`` returned)."""
    env = child_env({"OMP_NUM_THREADS": "1", "REPRO_DIST_BACKEND": "gloo",
                     **(env or {})})
    logs = [Path(cwd) / f"rank{i}.log" for i in range(world)]
    procs = []
    for i in range(world):
        with open(logs[i], "w") as f:
            procs.append(subprocess.Popen(argv_of(i), cwd=str(ROOT),
                                          env=env, stdout=f,
                                          stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    failed, result = None, None
    try:
        if during is not None:
            result = during()
        while any(p.poll() is None for p in procs):
            bad = [i for i, p in enumerate(procs)
                   if p.poll() not in (None, 0)]
            if bad or time.monotonic() > deadline:
                failed = bad or "timeout"
                break
            time.sleep(0.05)
        else:
            bad = [i for i, p in enumerate(procs) if p.returncode != 0]
            failed = bad or None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    text = [f.read_text() for f in logs]
    if failed:
        raise RuntimeError(f"ranks {failed} failed:\n" + "\n".join(
            f"--- rank {i} ---\n{t[-4000:]}" for i, t in enumerate(text)))
    return text, result


if __name__ == "__main__":
    main()
