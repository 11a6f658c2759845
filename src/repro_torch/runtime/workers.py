"""Multi-process target-generation workers, their supervisor, and the
membership roster of elastic trainers.

The twin of the reference's ``runtime/workers.py`` (paper §3.2: the
teacher's target generation as an embarrassingly parallel fleet over a
shared store), under the same names and file formats:

* :func:`worker_main` -- the worker CLI (``python -m
  repro_torch.runtime.workers --spec job.json --worker-id 3``).  Each
  worker attaches to the shared :class:`~repro_torch.pipeline.generate
  .WorkLedger`, races ``claim_shared`` for shard ranges, runs its engine
  over the claimed batches and commits shards through the store's locked
  manifest path, while a :class:`~repro_torch.runtime.procs.Heartbeat`
  thread proves it alive.  A worker that finds no pending range but an
  unfinished ledger *waits*: a sibling may die and its claims come back.
* :class:`Supervisor` -- spawns N workers as fresh interpreters (never a
  fork of a parent that may hold a CUDA context), watches children and
  heartbeats, reclaims claims of dead children at once (by owner) and of
  hung ones by heartbeat age, respawns up to ``max_restarts``
  replacements, and drains once the ledger completes.
* engine factories -- process-crossing engines are named
  ``"module:function"`` specs inside ``repro_torch`` (resolved by
  ``pipeline.generate.resolve_engine_factory``):
  :func:`linear_probe_engine` is the deterministic numpy reference,
  :func:`teacher_engine` a TeacherRunner from a checkpoint of the port's
  ``CheckpointStore`` (the ``topk_logits`` kernel on the card).
* :class:`TrainerMembership` / :class:`LaneCrashPlan` -- the roster an
  elastic ``Trainer.fit(membership=...)`` polls, and its scripted
  kill/revive script.

Shard contents depend only on the batch and the engine spec, never on
which worker (or how many) produced them, so the N-process manifest is
bitwise the in-process one and stealing a hung worker's claim is safe.

Differences from the reference, on purpose:
* Each worker, as it exits, writes ``_procs/worker<id>-<pid>.json``
  beside the job spec: the shards it wrote, the wall clock once its
  imports ran and as it exits, its seconds building the engine, in
  forwards and in writes, ``str(device)`` and the CUDA device's name, each kernel's
  launch count in the process, and the modules of ``jax`` or ``repro``
  it had imported (none).  Its stdout and stderr go to
  ``_procs/worker<id>-<pid>.log`` (not to ``/dev/null``): a worker whose
  engine fails to build or launch exits non-zero with its traceback
  there, and the supervisor's error quotes it.  ``Supervisor.run``'s
  report adds the reports as ``workers``.
* :class:`LaneCrashPlan` beats, at each poll, every lane its script
  holds live (joined, not left, not killed by it), before counting: the
  reference's lanes beat only when they join, so a wave longer than the
  roster's timeout made every lane look dead.
* Engine kwargs carry ``device`` (default ``"cuda"``).
* A ``crash`` stanza fires once a job (the reference re-arms it in the
  killed worker's replacement, which then dies again if it claims work),
  so a fault-injection run is deterministic even with one process.
* ``run_supervised_generation`` clears ``<store>/_procs/`` (an earlier
  pass's job, reports and logs) before staging its own.
* Under a ``runtime.cluster`` fleet each rank runs a Supervisor of its
  own over the one ledger (``pipeline.generate.generate_across_ranks``
  with ``processes``): its job, reports and logs under
  ``_procs/rank<r>/``, its workers' owners ``rank<r>-proc<id>-<pid>``;
  a crash stanza arms its worker on every rank, and fires in the first
  to reach it, once a fleet.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
import traceback
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.pipeline.generate import (WorkLedger,
                                           resolve_engine_factory,
                                           run_shared_claims)
from repro_torch.runtime import procs
from repro_torch.store.logit_store import LogitStoreV2

LOADED_AT = time.time()        # wall clock once this module's imports ran
KERNELS = ("topk_logits", "sparse_ce", "gtc_compress", "decode_attention",
           "topk_sample", "swa_attention")

# ---------------------------------------------------------------- job spec


def save_batches(path: str, batches: Sequence[dict]) -> str:
    """List-of-dict batches -> one .npz (keys ``"<i>.<field>"``)."""
    arrays = {}
    for i, b in enumerate(batches):
        for key, arr in b.items():
            arrays[f"{i}.{key}"] = np.asarray(arr)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **arrays)
    return path


def load_batches(path: str) -> List[dict]:
    """Inverse of :func:`save_batches` (order restored by index)."""
    z = np.load(path)
    out: Dict[int, dict] = {}
    for name in z.files:
        i, _, key = name.partition(".")
        out.setdefault(int(i), {})[key] = z[name]
    return [out[i] for i in sorted(out)]


def write_job_spec(path: str, *, store_root: str, k: int, vocab: int,
                   ledger_path: str, wave: int, batches_npz: str,
                   engine_spec: str, engine_kwargs: Optional[dict] = None,
                   heartbeat_interval_s: float = 0.25,
                   crash: Optional[dict] = None,
                   rank: Optional[int] = None) -> str:
    """The JSON contract between supervisor and workers.

    ``crash`` is the fault-injection stanza: ``{"worker": id,
    "after_shards": n}`` arms a :class:`~repro_torch.runtime.procs
    .CrashPoint` in that worker -- SIGKILL after its n-th shard write,
    mid-range, exactly like losing the machine.  It fires once a job:
    the killed worker's replacement runs disarmed.  ``rank``: the fleet
    rank whose supervisor runs this job (None alone).  Under a fleet the
    stanza arms its worker on every rank, and the first to reach its
    n-th shard fires: once a fleet.
    """
    spec = {"store_root": store_root, "k": int(k), "vocab": int(vocab),
            "ledger_path": ledger_path, "wave": int(wave),
            "batches_npz": batches_npz, "engine_spec": engine_spec,
            "engine_kwargs": engine_kwargs or {},
            "heartbeat_interval_s": heartbeat_interval_s,
            "crash": crash}
    if rank is not None:
        spec["rank"] = int(rank)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(spec, f, indent=1)
    os.replace(tmp, path)
    return path


def crash_marker(batches_npz: str) -> str:
    """The file a crash stanza's worker leaves as it fires, beside the
    job's batches (under a fleet, the one batches file of every rank's
    job): the stanza fires once a job, and once a fleet."""
    return os.path.join(os.path.dirname(os.path.abspath(batches_npz)),
                        "crash.fired")


def report_path(spec_path: str, worker_id: int, pid: int,
                suffix: str = "json") -> str:
    """``<spec dir>/worker<id>-<pid>.<suffix>``: a worker's exit report
    (``json``) or its output (``log``)."""
    return os.path.join(os.path.dirname(os.path.abspath(spec_path)),
                        f"worker{worker_id}-{pid}.{suffix}")


# ------------------------------------------------------------ worker side

def owner_name(worker_id: int, pid: Optional[int] = None,
               rank: Optional[int] = None) -> str:
    """Claim owner id: ``proc<worker>-<pid>``, under a fleet
    ``rank<r>-proc<worker>-<pid>``.  The pid makes a respawned
    replacement distinguishable from its dead predecessor, so the
    supervisor can reclaim the old claims by exact owner; the rank keeps
    two ranks' worker 0 apart in the one ledger and heartbeat
    directory."""
    name = f"proc{worker_id}-{os.getpid() if pid is None else pid}"
    return name if rank is None else f"rank{rank}-{name}"


def _engine_device(engine) -> str:
    """Where ``engine`` runs: its ``device`` (a TeacherRunner's), else
    the host (the numpy engines)."""
    return str(getattr(engine, "device", None) or "cpu")


def kernel_launches() -> dict:
    """Each kernel's launch count in this process (0 for a kernel module
    never imported)."""
    return {k: int(getattr(sys.modules.get(
        f"repro_torch.kernels.{k}.kernel"), "LAUNCHES", 0)) for k in KERNELS}


def process_report(engine=None) -> dict:
    """What a worker reports of its process: the engine's device, the
    CUDA device's name when it runs there, each kernel's launch count
    (0 for a kernel module never imported) and the imported modules of
    ``jax`` or ``repro`` (which the port must never load)."""
    device = _engine_device(engine) if engine is not None else None
    name = None
    if device is not None and device.startswith("cuda"):
        import torch
        name = torch.cuda.get_device_name(torch.device(device))
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    return {"device": device, "device_name": name,
            "launches": kernel_launches(),
            "foreign_modules": foreign}


def run_worker(spec: dict, worker_id: int, *, poll_s: float = 0.05,
               report: Optional[dict] = None) -> int:
    """One worker's life: attach, claim, generate, commit, repeat.

    Returns the number of shards written.  Leaves the claim loop only
    when the ledger is fully done -- a worker with nothing pending but an
    unfinished ledger parks and re-polls, because a hung sibling's claims
    may be stolen back to pending at any moment and *someone* must be
    alive to take them.  ``report`` (a dict) collects the shards written,
    their real frames, the seconds building the engine, in forwards and
    in store writes, and the engine.
    """
    report = {} if report is None else report
    report.update(shards=[], ranges=[], frames_written=0, engine_s=0.0,
                  forward_s=0.0, write_s=0.0)
    rank = spec.get("rank")
    owner = owner_name(worker_id, rank=rank)
    ledger = WorkLedger.attach(spec["ledger_path"])
    crash_cfg = spec.get("crash") or {}
    fired = crash_marker(spec["batches_npz"])
    crash = procs.CrashPoint(
        crash_cfg.get("after_shards")
        if crash_cfg.get("worker") == worker_id
        and not os.path.exists(fired) else None)
    store = LogitStoreV2(spec["store_root"], k=spec["k"],
                         vocab=spec["vocab"], shared=True)
    batches = load_batches(spec["batches_npz"])

    def engine():
        if "engine" not in report:
            t0 = time.perf_counter()
            factory = resolve_engine_factory(spec["engine_spec"])
            report["engine"] = factory(worker_id,
                                       spec.get("engine_kwargs", {}))
            report["engine_s"] = time.perf_counter() - t0
        return report["engine"]

    def after_shard():
        if crash.after is not None and crash.ticks >= crash.after:
            try:                        # once a job: the replacement runs
                os.close(os.open(fired, os.O_CREAT | os.O_EXCL))  # disarmed,
            except FileExistsError:     # and once a fleet: another rank's
                crash.after = None      # worker fired first
        crash.tick()                    # fault injection fires HERE --
        # after a commit, before mark_done: the killed worker leaves a
        # claimed range with real partial work behind

    with procs.Heartbeat(ledger.heartbeat_dir, owner,
                         interval_s=spec.get("heartbeat_interval_s",
                                             0.25)):
        run_shared_claims(ledger, owner, batches, store, engine, report,
                          park_s=poll_s, after_shard=after_shard)
    return len(report["shards"])


def worker_main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="ledgered target-generation worker (one process of "
                    "the fleet; spawned by runtime.workers.Supervisor)")
    ap.add_argument("--spec", required=True)
    ap.add_argument("--worker-id", type=int, required=True)
    args = ap.parse_args(argv)
    with open(args.spec) as f:
        spec = json.load(f)
    rep: dict = {"worker": args.worker_id, "pid": os.getpid(),
                 "owner": owner_name(args.worker_id, rank=spec.get("rank")),
                 "t_loaded": LOADED_AT}
    if spec.get("rank") is not None:
        rep["rank"] = spec["rank"]
    code = 0
    try:
        run_worker(spec, args.worker_id, report=rep)
    except Exception:                       # the worker's boundary: reported
        traceback.print_exc()
        rep["error"] = traceback.format_exc(limit=8)
        code = 1
    rep.update(process_report(rep.pop("engine", None)))
    rep["n_written"] = len(rep.get("shards", []))
    rep["t_exit"] = time.time()
    path = report_path(args.spec, args.worker_id, os.getpid())
    with open(path + ".tmp", "w") as f:
        json.dump(rep, f, indent=1)
    os.replace(path + ".tmp", path)
    print(f"[worker {args.worker_id}] wrote {rep['n_written']} shards on "
          f"{rep['device']}", flush=True)
    return code


# -------------------------------------------------------- supervisor side

class Supervisor:
    """Spawn/watch/reclaim/drain for a fleet of generation workers.

    The loop, every ``poll_s``:

    1. reap exited children -- claims of a *dead* worker are reclaimed
       at once by exact owner (no need to wait out the heartbeat
       timeout), and a replacement is spawned while restart budget
       remains and pending work exists;
    2. steal from *hung* workers -- ``reclaim_stale`` demotes claims
       whose owner's heartbeat is older than ``heartbeat_timeout_s``;
    3. drain -- once the ledger is all done, workers exit on their own;
       join with a grace period, then terminate stragglers.

    ``run`` raises RuntimeError if the wave cannot complete (restart
    budget exhausted with work pending, or ``timeout_s`` elapsed),
    quoting the last failed worker's log.
    """

    def __init__(self, spec_path: str, n_procs: int, *,
                 heartbeat_timeout_s: float = 3.0, poll_s: float = 0.05,
                 max_restarts: Optional[int] = None,
                 claim_timeout_s: Optional[float] = None,
                 python: str = sys.executable):
        self.spec_path = spec_path
        self.n_procs = n_procs
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.poll_s = poll_s
        self.max_restarts = n_procs if max_restarts is None else max_restarts
        # second staleness signal: a claim held longer than this is
        # stolen even under a fresh heartbeat; None disables
        self.claim_timeout_s = claim_timeout_s
        self.python = python
        with open(spec_path) as f:
            self.spec = json.load(f)
        self.rank = self.spec.get("rank")
        self.ledger = WorkLedger.attach(self.spec["ledger_path"])
        self.children: Dict[int, subprocess.Popen] = {}
        self.child_owner: Dict[int, str] = {}
        self.spawned: List[tuple] = []      # (worker, pid) of every child
        self.n_restarts = 0
        self.n_reclaimed = 0
        self.last_failure: Optional[str] = None
        # structured lifecycle log (spawn/exit/respawn), merged with the
        # ledger's steal events into run()'s report
        self.events: List[dict] = []

    # ------------------------------------------------------------ spawn

    def _spawn(self, worker_id: int) -> subprocess.Popen:
        log_tmp = report_path(self.spec_path, worker_id,
                              len(self.spawned), "spawn.log")
        with open(log_tmp, "w") as log:
            p = subprocess.Popen(
                [self.python, "-m", "repro_torch.runtime.workers",
                 "--spec", self.spec_path, "--worker-id", str(worker_id)],
                env=procs.child_env(), stdout=log, stderr=subprocess.STDOUT)
        os.replace(log_tmp, report_path(self.spec_path, worker_id, p.pid,
                                        "log"))
        self.children[worker_id] = p
        self.child_owner[worker_id] = owner_name(worker_id, p.pid,
                                                 self.rank)
        self.spawned.append((worker_id, p.pid))
        self.events.append({"event": "spawn", "worker": worker_id,
                            "owner": self.child_owner[worker_id],
                            "t": time.time()})
        return p

    def _reap_and_respawn(self):
        for wid, p in list(self.children.items()):
            if p.poll() is None:
                continue
            del self.children[wid]
            owner = self.child_owner.pop(wid)
            stolen = self.ledger.reclaim_stale(
                max_age_s=0.0, owners=[owner])
            self.n_reclaimed += len(stolen)
            self.events.append({"event": "exit", "worker": wid,
                                "owner": owner,
                                "returncode": p.returncode,
                                "stolen": len(stolen), "t": time.time()})
            if p.returncode != 0:
                self.last_failure = self._log_tail(wid, p.pid)
            self.ledger.refresh()
            if (not self.ledger.all_done
                    and self.n_restarts < self.max_restarts
                    and (p.returncode != 0 or stolen)):
                # nonzero exit or died holding work: spawn a successor
                # (a clean exit with nothing stolen is just "done")
                self.n_restarts += 1
                self.events.append({"event": "respawn", "worker": wid,
                                    "t": time.time()})
                self._spawn(wid)

    def _log_tail(self, wid: int, pid: int, n: int = 4000) -> str:
        try:
            with open(report_path(self.spec_path, wid, pid, "log")) as f:
                return f"worker {wid} (pid {pid}): " + f.read()[-n:]
        except OSError:
            return f"worker {wid} (pid {pid}): no log"

    def _fail(self, msg: str):
        if self.last_failure:
            msg += "; the last failed worker's output:\n" + self.last_failure
        raise RuntimeError(msg)

    # -------------------------------------------------------------- run

    def run(self, *, timeout_s: float = 120.0) -> Dict:
        t0 = time.monotonic()
        for wid in range(self.n_procs):
            self._spawn(wid)
        try:
            while True:
                self.ledger.refresh()
                if self.ledger.all_done:
                    break
                if time.monotonic() - t0 > timeout_s:
                    self._fail(
                        f"generation wave incomplete after {timeout_s}s "
                        f"({self.ledger.n_done}/"
                        f"{len(self.ledger.ranges)} ranges done)")
                self._reap_and_respawn()
                if not self.children and not self.ledger.all_done:
                    if self.n_restarts >= self.max_restarts:
                        self._fail("all workers dead, restart budget "
                                   "exhausted, work pending")
                stolen = self.ledger.reclaim_stale(
                    max_age_s=self.heartbeat_timeout_s,
                    claim_timeout_s=self.claim_timeout_s)
                self.n_reclaimed += len(stolen)
                time.sleep(self.poll_s)
            self._drain()
        finally:
            self._terminate_all()
        return {"processes": self.n_procs, "restarts": self.n_restarts,
                "reclaimed": self.n_reclaimed,
                "events": self.events + self.ledger.events,
                "workers": self.reports()}

    def reports(self) -> List[dict]:
        """The exit reports of every child spawned, in spawn order (a
        SIGKILLed child wrote none)."""
        out = []
        for wid, pid in self.spawned:
            try:
                with open(report_path(self.spec_path, wid, pid)) as f:
                    out.append(json.load(f))
            except OSError:
                continue
        return out

    def _drain(self, grace_s: float = 5.0):
        """Ledger complete: workers are exiting on their own -- give them
        the grace period (each writes its report), then insist."""
        deadline = time.monotonic() + grace_s
        for wid, p in list(self.children.items()):
            try:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.terminate()
                p.wait()
            self.children.pop(wid, None)

    def _terminate_all(self):
        for p in self.children.values():
            if p.poll() is None:
                p.kill()
            p.wait()
        self.children.clear()


def stage_batches(store, batches) -> str:
    """Clear ``<store>/_procs/`` (an earlier pass's job, reports and
    logs) and write the pass's batches there; -> their path.  Under a
    fleet rank 0 calls it once for every rank's job."""
    work_dir = os.path.join(store.root, "_procs")
    shutil.rmtree(work_dir, ignore_errors=True)
    return save_batches(os.path.join(work_dir, "batches.npz"), batches)


def run_supervised_generation(ledger: WorkLedger, batches, store, *,
                              engine_spec: str, engine_kwargs: dict,
                              n_procs: int, crash: Optional[dict] = None,
                              heartbeat_timeout_s: float = 3.0,
                              timeout_s: float = 120.0,
                              max_restarts: Optional[int] = None,
                              claim_timeout_s: Optional[float] = None,
                              rank: Optional[int] = None) -> Dict:
    """``generate_sharded(processes=N)``'s backend: stage the job under
    ``<store>/_procs/``, run a Supervisor over the prepared ledger, and
    hand back a completion report.  The ledger and wave decisions were
    already made by ``prepare_ledger``; this only executes them.  Besides
    the reference's keys, the report sums the workers' ``frames_written``
    (of the shards they wrote, a stolen range's rewrites included),
    ``forward_s`` and ``write_s``.

    ``rank`` (under a fleet, ``generate_across_ranks``): this rank's
    supervisor runs its job from ``<store>/_procs/rank<r>/`` (spec,
    reports, logs) over the batches rank 0 staged (:func:`stage_batches`),
    its workers' owners named with the rank; every rank's fleet races the
    one ledger, and each supervisor returns once it is all done."""
    if rank is None:
        npz = stage_batches(store, batches)
        spec_dir = os.path.dirname(npz)
    else:
        npz = os.path.join(store.root, "_procs", "batches.npz")
        spec_dir = os.path.join(store.root, "_procs", f"rank{rank}")
    spec_path = write_job_spec(
        os.path.join(spec_dir, "job.json"),
        store_root=store.root, k=store.k, vocab=store.vocab,
        ledger_path=ledger.path, wave=ledger.wave, batches_npz=npz,
        engine_spec=engine_spec, engine_kwargs=engine_kwargs, crash=crash,
        rank=rank)
    sup = Supervisor(spec_path, n_procs,
                     heartbeat_timeout_s=heartbeat_timeout_s,
                     max_restarts=max_restarts,
                     claim_timeout_s=claim_timeout_s)
    rep = sup.run(timeout_s=timeout_s)
    # adopt the workers' commits: the in-memory manifest predates them
    store.manifest = type(store.manifest).load(store.root)
    ledger.refresh()
    if not ledger.all_done:
        raise RuntimeError(f"the fleet drained with {ledger.n_done} of "
                           f"{len(ledger.ranges)} ranges done")
    rep["n_written"] = sum(r.hi - r.lo for r in ledger.ranges)
    for key in ("frames_written", "forward_s", "write_s"):
        rep[key] = sum(w.get(key, 0) for w in rep["workers"])
    return rep


# --------------------------------------------------------- engine factories

class _LinearProbeEngine:
    """Deterministic numpy engine: top-k of a fixed random projection.

    Content depends only on the batch and (k, vocab, seed) -- never on
    the worker -- so any partition of the corpus over any number of
    workers or processes produces byte-identical shards, and the same
    bytes as the reference's engine of the same name.
    """

    def __init__(self, k: int, vocab: int, seed: int = 0,
                 flops_per_frame: int = 0):
        self.k = k
        self.vocab = vocab
        self.seed = seed
        self.flops_per_frame = flops_per_frame
        self._w = None

    def forward_topk(self, batch):
        feats = np.asarray(batch["feats"], np.float32)
        if self._w is None:
            rng = np.random.default_rng(self.seed)
            self._w = rng.normal(
                size=(feats.shape[-1], self.vocab)).astype(np.float32)
        logits = feats @ self._w
        if self.flops_per_frame:            # simulated model cost knob
            for _ in range(self.flops_per_frame):
                logits = logits + 0.0
        idx = np.argsort(-logits, axis=-1)[..., :self.k].astype(np.int32)
        vals = np.take_along_axis(logits, idx, axis=-1)
        vals = vals - vals[..., :1]
        return vals, idx


def linear_probe_engine(worker_id: int, kwargs: dict):
    """Factory spec ``repro_torch.runtime.workers:linear_probe_engine``."""
    del worker_id                           # determinism: worker-blind
    return _LinearProbeEngine(int(kwargs.get("k", 20)),
                              int(kwargs["vocab"]),
                              seed=int(kwargs.get("seed", 0)),
                              flops_per_frame=int(
                                  kwargs.get("flops_per_frame", 0)))


def engine_from_checkpoint(cfg, ckpt_dir: str, k: int, device,
                           step: Optional[int] = None):
    """A TeacherRunner of ``cfg`` over the params ``ckpt_dir`` (a
    ``CheckpointStore`` root) holds at ``step`` (default: the latest),
    on ``device``."""
    from repro_torch.checkpoint import load_params
    from repro_torch.core.teacher import TeacherRunner
    from repro_torch.kernels._dispatch import resolve_device
    device = resolve_device(device)
    params = load_params(cfg, ckpt_dir, device, step)
    if params is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    return TeacherRunner(cfg, params, k=k, device=device)


def teacher_engine(worker_id: int, kwargs: dict):
    """Factory spec ``repro_torch.runtime.workers:teacher_engine``: a
    TeacherRunner from params on disk.

    kwargs: ``ckpt_dir`` (a ``CheckpointStore`` root holding the teacher
    params, the port's or the reference's file), ``k``, optional ``arch``
    (default the paper's bidirectional teacher; ``reduced`` true for its
    ``configs.reduced`` widths), ``step`` (default: the latest) and
    ``device`` (default ``"cuda"``; raises without CUDA).
    Each process pays its own torch import, CUDA context and weights,
    exactly the deployment cost model.
    """
    del worker_id
    from repro_torch.configs import get_arch, reduced
    cfg = get_arch(kwargs.get("arch", "lstm-am-teacher"))
    if kwargs.get("reduced"):
        cfg = reduced(cfg)
    return engine_from_checkpoint(
        cfg, kwargs["ckpt_dir"], int(kwargs.get("k", 20)),
        kwargs.get("device", "cuda"), kwargs.get("step"))


# ------------------------------------------------------ trainer membership

class TrainerMembership:
    """Shared membership roster for elastic trainers.

    The generation fleet's liveness machinery (heartbeats + ``file_lock``)
    extended to *training* workers: a locked JSON roster records who
    joined and left, heartbeat files prove who is still alive, and
    ``live_count()`` is the runtime W the Trainer polls at block
    boundaries (``Trainer.fit(membership=...)``).  The files are the
    reference's, so either package reads a roster the other wrote.

        m = TrainerMembership(path, timeout_s=3.0)
        m.join("lane0"); m.join("lane1")
        m.live()          # ["lane0", "lane1"]
        m.kill("lane1")   # simulated SIGKILL: backdate the heartbeat
        m.live_count()    # 1 -> the next block shrinks to W=1

    A member is live iff it joined, has not left, and its heartbeat is no
    older than ``timeout_s``.  ``join`` is also the *re*-join path.
    """

    def __init__(self, path: str, *, timeout_s: float = 3.0,
                 interval_s: float = 0.25):
        self.path = path
        self.timeout_s = timeout_s
        self.interval_s = interval_s
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    @property
    def lock_path(self) -> str:
        return self.path + ".lock"

    @property
    def heartbeat_dir(self) -> str:
        return os.path.join(os.path.dirname(self.path) or ".",
                            "trainer_heartbeats")

    def _load(self) -> Dict:
        try:
            with open(self.path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {"workers": {}}

    def _save(self, d: Dict):
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(d, f, indent=1)
        os.replace(tmp, self.path)

    # -------------------------------------------------------- transitions

    def join(self, worker: str):
        """Register (or re-register) a live worker; beats synchronously
        so the member is live the moment join returns."""
        with procs.file_lock(self.lock_path):
            d = self._load()
            d["workers"][worker] = {"joined": time.time(), "left": None}
            self._save(d)
        procs.beat(self.heartbeat_dir, worker)

    def leave(self, worker: str):
        """Clean departure: not live at once, no timeout to wait."""
        with procs.file_lock(self.lock_path):
            d = self._load()
            if worker in d["workers"]:
                d["workers"][worker]["left"] = time.time()
                self._save(d)

    def beat(self, worker: str):
        procs.beat(self.heartbeat_dir, worker)

    def heartbeat(self, worker: str) -> procs.Heartbeat:
        """Background beat thread for a real trainer process."""
        return procs.Heartbeat(self.heartbeat_dir, worker,
                               interval_s=self.interval_s)

    def kill(self, worker: str, *, age_s: Optional[float] = None):
        """Fault injection: make a member look SIGKILLed *now* by
        backdating its heartbeat past the timeout."""
        age = self.timeout_s + 1.0 if age_s is None else age_s
        hb = procs.heartbeat_path(self.heartbeat_dir, worker)
        if not os.path.exists(hb):
            procs.beat(self.heartbeat_dir, worker)
        then = time.time() - age
        os.utime(hb, (then, then))

    # ------------------------------------------------------------ queries

    def roster(self) -> Dict:
        with procs.file_lock(self.lock_path):
            return self._load()["workers"]

    def live(self, *, now: Optional[float] = None) -> List[str]:
        now = time.time() if now is None else now
        out = []
        for name, rec in sorted(self.roster().items()):
            if rec.get("left") is not None:
                continue
            age = procs.heartbeat_age(self.heartbeat_dir, name, now=now)
            if age is not None and age <= self.timeout_s:
                out.append(name)
        return out

    def live_count(self) -> int:
        return len(self.live())


class LaneCrashPlan:
    """Scripted kills and revives at exact poll indices, for membership.

    Wraps a :class:`TrainerMembership` as the object ``Trainer.fit``
    polls (one poll before the first update, then one after each update,
    i.e. per BMUF block), so chaos runs replay exactly: "kill lane2 after
    block 2, revive it after block 5".

        plan = LaneCrashPlan(m, kills={2: "lane2"}, revives={5: "lane2"})
        trainer.fit(state, source, membership=plan)

    At each poll, after firing its events, the plan beats every lane its
    script holds live (in the roster, not left, not killed by it), so the
    count it returns is the script's however long a block takes.  ``log``
    records every fired event.
    """

    def __init__(self, membership: TrainerMembership, *,
                 kills: Optional[Dict[int, str]] = None,
                 revives: Optional[Dict[int, str]] = None):
        self.membership = membership
        self.kills = dict(kills or {})
        self.revives = dict(revives or {})
        self.polls = 0
        self.dead: set = set()
        self.log: List[dict] = []

    def live_count(self) -> int:
        n = self.polls
        self.polls += 1
        if n in self.kills:
            self.membership.kill(self.kills[n])
            self.dead.add(self.kills[n])
            self.log.append({"event": "kill", "poll": n,
                             "worker": self.kills[n]})
        if n in self.revives:
            self.membership.join(self.revives[n])
            self.dead.discard(self.revives[n])
            self.log.append({"event": "revive", "poll": n,
                             "worker": self.revives[n]})
        for name, rec in self.membership.roster().items():
            if rec.get("left") is None and name not in self.dead:
                self.membership.beat(name)
        return self.membership.live_count()


if __name__ == "__main__":
    sys.exit(worker_main())
