"""Sharded teacher target generation (paper §3.2: "parallelize target
generation").

The port's twin of the reference's ``pipeline/generate.py``, in-process.
The corpus is partitioned into contiguous shard ranges, one range claim
at a time: each worker runs its own engine (a ``TeacherRunner`` over a
``StreamingEngine``, whose emission runs the ``topk_logits`` kernel on
the card) and writes its claimed range's shards into the manifest —
ranges are disjoint, so workers never contend on a shard id, and the
store's per-shard commit keeps the manifest consistent no matter the
interleaving.

Progress is tracked in a resumable **work ledger** (JSON next to the
store, the reference's file): a range is pending -> claimed -> done, the
file is rewritten atomically on every transition, and claims left
behind by a killed worker demote back to pending when the ledger is
reopened — a fresh invocation re-claims exactly the unfinished ranges.
Shard contents are deterministic, so re-running a half-finished range
rewrites its shards idempotently.

In-process, the "workers" run round-robin inside one process; the
claim/ledger protocol is identical to what N real processes against a
shared filesystem execute through the ledger's shared mode (``attach`` /
``claim_shared`` / ``mark_done_shared`` / ``reclaim_stale``,
``fcntl``-locked with heartbeat files), which
``generate_sharded(processes=N)`` drives through
``runtime/workers.py``'s Supervisor, and ``generate_across_ranks`` over
the ranks of a ``runtime.cluster`` fleet, in each rank's process or in a
Supervisor's worker processes a rank (all through ``run_shared_claims``,
the shared-mode claim loop).  An engine named
across the process boundary is a ``"module:function"`` spec inside
``repro_torch``: a spec the reference wrote names ``repro.``, which would
import JAX in a port worker, and is refused.
``TeacherRunner.generate_to_store`` and ``generate_corpus_to_store``
(core/teacher.py) are thin single-worker special cases of the helpers
here.
"""
from __future__ import annotations

import importlib
import json
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.runtime.procs import file_lock, heartbeat_age


def shard_ranges(n_items: int, n_workers: int) -> List[Tuple[int, int]]:
    """Partition [0, n_items) into n_workers contiguous [lo, hi) ranges
    (the first ``n_items % n_workers`` ranges get the extra item)."""
    if n_workers < 1:
        raise ValueError(f"n_workers must be >= 1, got {n_workers}")
    base, extra = divmod(n_items, n_workers)
    ranges, lo = [], 0
    for w in range(n_workers):
        hi = lo + base + (1 if w < extra else 0)
        if hi > lo:
            ranges.append((lo, hi))
        lo = hi
    return ranges


@dataclass
class WorkRange:
    lo: int
    hi: int
    status: str = "pending"          # pending | claimed | done
    owner: Optional[str] = None
    claim_ts: Optional[float] = None  # wall time of the claim (shared mode)


class WorkLedger:
    """Resumable range ledger with atomic on-disk transitions.

    ``open`` on an existing file demotes stale "claimed" entries back to
    "pending" — any claim in a freshly-loaded ledger belongs to a dead
    worker by definition (live claims exist only in the process that
    made them).  "done" survives reopen: that is the resume contract.

    **Shared (multi-process) mode**: N processes race the same ledger
    file through ``claim_shared`` / ``mark_done_shared`` — each is an
    ``fcntl``-locked reload-modify-save, so claims serialize across
    processes on a shared filesystem.  Workers join via :meth:`attach`
    (NO reopen-time demotion — other processes' claims are live, not
    stale); liveness is instead tracked by heartbeat files
    (``runtime.procs``) and :meth:`reclaim_stale` steals claims
    whose owner's heartbeat has gone quiet — covering *hung* workers,
    which never reopen anything, as well as dead ones.  Stealing is
    safe because shard contents are deterministic and commits
    idempotent: if a presumed-dead worker wakes up and finishes, it
    rewrites byte-identical shards and its ``mark_done_shared`` is a
    no-op on an already-done range.
    """

    def __init__(self, path: str, ranges: List[WorkRange], *, wave: int = 0):
        self.path = path
        self.ranges = ranges
        self.wave = wave
        # structured steal log (this process's sweeps only — events are
        # observability, not shared state; see reclaim_stale)
        self.events: List[dict] = []

    # ------------------------------------------------------------ open/io

    @classmethod
    def open(cls, path: str, ranges: Sequence[Tuple[int, int]], *,
             wave: int = 0) -> "WorkLedger":
        if os.path.exists(path):
            with open(path) as f:
                d = json.load(f)
            stored = [(r["lo"], r["hi"]) for r in d["ranges"]]
            if stored != [tuple(r) for r in ranges]:
                raise ValueError(
                    f"ledger {path} partitions {stored}, caller wants "
                    f"{list(ranges)} — delete the ledger to repartition")
            led = cls(path, [WorkRange(r["lo"], r["hi"],
                                       "pending" if r["status"] == "claimed"
                                       else r["status"], None)
                             for r in d["ranges"]],
                      wave=int(d.get("wave", wave)))
        else:
            led = cls(path, [WorkRange(lo, hi) for lo, hi in ranges],
                      wave=wave)
        led._save()
        return led

    @classmethod
    def attach(cls, path: str) -> "WorkLedger":
        """Join an existing ledger as one of several live processes:
        load as-is — no demotion (other workers' claims are live), no
        partition check (the supervisor already wrote the partition),
        no save (attaching must not race a writer)."""
        with open(path) as f:
            d = json.load(f)
        return cls(path,
                   [WorkRange(r["lo"], r["hi"], r["status"],
                              r.get("owner"), r.get("claim_ts"))
                    for r in d["ranges"]],
                   wave=int(d.get("wave", 0)))

    @classmethod
    def fresh(cls, path: str, ranges: Sequence[Tuple[int, int]], *,
              wave: int = 0) -> "WorkLedger":
        """Start over (new generation wave): forget any previous ledger."""
        if os.path.exists(path):
            os.remove(path)
        return cls.open(path, ranges, wave=wave)

    def _save(self):
        payload = {"wave": self.wave,
                   "ranges": [{"lo": r.lo, "hi": r.hi, "status": r.status,
                               "owner": r.owner, "claim_ts": r.claim_ts}
                              for r in self.ranges]}
        tmp = self.path + ".tmp"
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1)
            f.flush()
            os.fsync(f.fileno())    # the crash-resume record must itself
        os.replace(tmp, self.path)  # survive a crash (as manifest.save)

    @classmethod
    def peek_all_done(cls, path: str) -> bool:
        """Is the ledger at `path` a *completed* pass?  False for a
        missing or unreadable file — used to decide fresh-vs-resume
        before the partition check (a completed pass may be freshly
        repartitioned; an unfinished one must keep its ranges)."""
        try:
            with open(path) as f:
                d = json.load(f)
            return bool(d["ranges"]) and all(
                r["status"] == "done" for r in d["ranges"])
        except (OSError, ValueError, KeyError):
            return False

    # ------------------------------------------------------- transitions

    def claim(self, owner: str) -> Optional[WorkRange]:
        """Claim the next pending range for `owner` (None when none left).
        Committed to disk before returning, so a worker killed mid-range
        leaves a visible "claimed" entry for the next run to demote."""
        for r in self.ranges:
            if r.status == "pending":
                r.status, r.owner = "claimed", owner
                self._save()
                return r
        return None

    def mark_done(self, rng: WorkRange):
        rng.status, rng.owner = "done", None
        self._save()

    # --------------------------------------- shared (multi-process) mode

    @property
    def lock_path(self) -> str:
        return self.path + ".lock"

    @property
    def heartbeat_dir(self) -> str:
        return os.path.join(os.path.dirname(self.path) or ".",
                            "heartbeats")

    def _reload(self):
        """Adopt the on-disk state (caller holds the lock)."""
        with open(self.path) as f:
            d = json.load(f)
        self.ranges = [WorkRange(r["lo"], r["hi"], r["status"],
                                 r.get("owner"), r.get("claim_ts"))
                       for r in d["ranges"]]
        self.wave = int(d.get("wave", self.wave))

    def claim_shared(self, owner: str) -> Optional[WorkRange]:
        """Multi-process claim: locked reload -> first pending ->
        claimed(owner, now) -> save.  Two processes racing this see
        serialized ledgers and can never claim the same range."""
        with file_lock(self.lock_path):
            self._reload()
            for r in self.ranges:
                if r.status == "pending":
                    r.status, r.owner = "claimed", owner
                    r.claim_ts = time.time()
                    self._save()
                    return r
        return None

    def mark_done_shared(self, rng: WorkRange):
        """Locked done-transition, matched by (lo, hi) against the
        reloaded state.  Idempotent: an already-done range (a stolen
        claim the original owner also finished) stays done."""
        with file_lock(self.lock_path):
            self._reload()
            for r in self.ranges:
                if (r.lo, r.hi) == (rng.lo, rng.hi):
                    r.status, r.owner, r.claim_ts = "done", None, None
                    self._save()
                    return
        raise ValueError(f"range ({rng.lo}, {rng.hi}) not in ledger")

    def reclaim_stale(self, *, max_age_s: float,
                      owners: Optional[Sequence[str]] = None,
                      now: Optional[float] = None,
                      claim_timeout_s: Optional[float] = None
                      ) -> List[WorkRange]:
        """Steal claims from quiet owners (the heartbeat-age contract).

        A claimed range demotes back to pending when its owner's
        heartbeat file is older than ``max_age_s`` — or was never
        written, with the claim itself older than ``max_age_s`` (died
        before the first beat).  ``claim_timeout_s`` adds a second
        staleness signal: the claim's *own* age.  A worker whose beat
        thread outlives its hung main loop (it died between beat and
        claim progress) keeps a fresh heartbeat forever and the
        heartbeat path alone never steals from it; with a claim timeout
        the claim is stolen by age regardless.  Safe because done
        transitions are idempotent — a resurrected owner finishing a
        stolen range is a no-op.  ``owners`` narrows the sweep to known
        casualties (the supervisor passes a dead child's owner id for
        immediate reclaim without waiting out the heartbeat timeout).
        Returns the ranges stolen; each steal is also appended to
        ``self.events`` as a structured record (who stole what from
        whom, which signal fired, how old).
        """
        now = time.time() if now is None else now
        stolen: List[WorkRange] = []
        events: List[dict] = []
        with file_lock(self.lock_path):
            self._reload()
            for r in self.ranges:
                if r.status != "claimed" or r.owner is None:
                    continue
                if owners is not None:
                    if r.owner not in owners:
                        continue
                    mode, age = "owner", None
                else:
                    age = heartbeat_age(self.heartbeat_dir, r.owner,
                                        now=now)
                    if age is None:         # never beat: age the claim
                        age = now - (r.claim_ts or 0.0)
                        mode = "never_beat"
                    else:
                        mode = "hb_age"
                    if age <= max_age_s:
                        claim_age = (None if r.claim_ts is None
                                     else now - r.claim_ts)
                        if (claim_timeout_s is not None
                                and claim_age is not None
                                and claim_age > claim_timeout_s):
                            mode, age = "claim_age", claim_age
                        else:
                            continue
                stolen.append(WorkRange(r.lo, r.hi, "claimed", r.owner,
                                        r.claim_ts))
                events.append({"event": "steal", "lo": r.lo, "hi": r.hi,
                               "from": r.owner, "mode": mode,
                               "age_s": None if age is None
                               else round(float(age), 3), "t": now})
                r.status, r.owner, r.claim_ts = "pending", None, None
            if stolen:
                self._save()
        self.events.extend(events)
        return stolen

    def refresh(self):
        """Re-read the on-disk state (locked) — the supervisor's view."""
        with file_lock(self.lock_path):
            self._reload()

    # ------------------------------------------------------------ queries

    @property
    def all_done(self) -> bool:
        return all(r.status == "done" for r in self.ranges)

    @property
    def n_done(self) -> int:
        return sum(r.status == "done" for r in self.ranges)


# --------------------------------------------------------------- drivers

def _utt_lens_of(batch) -> Optional[np.ndarray]:
    mask = batch.get("mask") if isinstance(batch, dict) else None
    if mask is None:
        return None
    return np.asarray(mask).sum(axis=-1).astype(np.int32)


def resolve_engine_factory(spec: str) -> Callable:
    """``"module:function"`` -> the factory callable.  The factory
    contract (process-crossing, so it must be importable by name):
    ``factory(worker_id: int, kwargs: dict) -> engine`` with the engine
    exposing ``forward_topk(batch) -> (vals, idx)``.  The module must be
    ``repro_torch`` or below (a reference spec, ``repro.…``, would import
    JAX)."""
    mod, _, fn = spec.partition(":")
    if not mod or not fn:
        raise ValueError(f"engine spec {spec!r}: want 'module:function'")
    if mod.split(".")[0] != "repro_torch":
        raise ValueError(f"engine spec {spec!r}: the module must be "
                         "repro_torch or below")
    return getattr(importlib.import_module(mod), fn)


def prepare_ledger(store, n_items: int, n_workers: int, *,
                   ledger_path: Optional[str] = None,
                   wave: Optional[int] = None) -> WorkLedger:
    """Fresh-vs-resume wave selection shared by the in-process and
    multi-process drivers.

    A ledger with unfinished ranges is a killed run — resume it at its
    recorded wave.  Otherwise (no ledger, or a completed one) this is a
    fresh generation pass and (unless ``wave`` is forced) it supersedes
    the store's live shards at ``store.next_wave()`` — so a deleted
    ledger, a different ledger_path, or a completed re-run all start
    above the live wave instead of tripping stale-wave rejection.
    """
    ledger_path = ledger_path or os.path.join(store.root, "gen_ledger.json")
    ranges = shard_ranges(n_items, n_workers)
    fresh_wave = store.next_wave() if wave is None else wave
    if not os.path.exists(ledger_path):       # brand-new pass
        return WorkLedger.open(ledger_path, ranges, wave=fresh_wave)
    if WorkLedger.peek_all_done(ledger_path):
        # completed pass: a new wave, freely repartitionable (the old
        # partition is history — only an *unfinished* ledger pins ranges)
        return WorkLedger.fresh(ledger_path, ranges, wave=fresh_wave)
    return WorkLedger.open(ledger_path, ranges)


def generate_sharded(make_engine: Union[Callable[[int], object], str],
                     batches: Sequence[dict], store, *,
                     n_workers: int = 1, ledger_path: Optional[str] = None,
                     wave: Optional[int] = None, processes: int = 0,
                     engine_kwargs: Optional[dict] = None,
                     crash: Optional[dict] = None,
                     supervisor_opts: Optional[dict] = None) -> Dict:
    """Pre-formed dict batches -> manifest shards, partitioned over workers.

    make_engine(worker_id) -> an object with ``forward_topk(batch)``
    (a StreamingEngine or TeacherRunner); engines are created lazily,
    one per worker that actually claims work.  Shard i holds batch i's
    frames — the trainer-aligned layout ``distill_shard_source`` reads.
    ``make_engine`` may instead be a ``"module:function"`` factory spec
    (called as ``factory(worker_id, engine_kwargs)``).

    ``processes=N`` (N >= 1) executes the SAME ledger protocol as N
    real OS processes through ``runtime.workers``: a supervisor spawns N
    workers that race ``claim_shared`` on the ledger, write shards
    through locked manifest commits and heartbeat; dead or hung workers
    have their claims stolen and the wave still completes, with a
    manifest bitwise the in-process path's.  It needs a
    ``"module:function"`` spec (a closure cannot cross a process
    boundary).  ``crash`` / ``supervisor_opts`` are the fault-injection
    and tuning passthroughs of ``runtime.workers``; the report adds the
    fleet's ``processes``, ``restarts``, ``reclaimed``, ``events`` and
    each worker's exit report (``workers``).  Wave selection (both
    paths): see :func:`prepare_ledger`.

    Besides the reference's report keys: ``frames_written``, the frames
    of the batches this call wrote (their mask sums; every frame of a
    batch without a mask), and ``forward_s`` and ``write_s``, the host
    seconds spent in the engines' forwards and in the store's appends
    (the host copy, the files, the checksum and the commit; summed over
    the workers in processes).  On the card a forward returns before its
    last kernels end, and their tail lands in the append's copy.
    """
    if isinstance(make_engine, str):        # refuse before any ledger
        factory = resolve_engine_factory(make_engine)
    elif processes and processes >= 1:
        raise ValueError(
            "generate_sharded(processes=N) needs a 'module:function' "
            "engine spec: a closure cannot cross a process boundary")
    ledger = prepare_ledger(store, len(batches), n_workers,
                            ledger_path=ledger_path, wave=wave)
    resumed = ledger.n_done > 0

    if processes and processes >= 1:
        from repro_torch.runtime.workers import run_supervised_generation
        rep = run_supervised_generation(
            ledger, batches, store, engine_spec=make_engine,
            engine_kwargs=engine_kwargs or {}, n_procs=processes,
            crash=crash, **(supervisor_opts or {}))
        rep.update({"n_shards": len(batches), "n_workers": n_workers,
                    "wave": ledger.wave, "resumed": resumed})
        return rep

    if isinstance(make_engine, str):
        kw = engine_kwargs or {}
        make_engine = lambda w: factory(w, kw)  # noqa: E731

    engines: Dict[int, object] = {}
    n_written = frames_written = 0
    forward_s = write_s = 0.0
    worker = 0
    while True:
        claim = ledger.claim(f"worker{worker}")
        if claim is None:
            break
        if worker not in engines:
            engines[worker] = make_engine(worker)
        eng = engines[worker]
        for i in range(claim.lo, claim.hi):
            t0 = time.perf_counter()
            vals, idx = eng.forward_topk(batches[i])
            t1 = time.perf_counter()
            lens = _utt_lens_of(batches[i])
            store.append_shard(i, vals, idx, lens, wave=ledger.wave)
            forward_s += t1 - t0
            write_s += time.perf_counter() - t1
            n_written += 1
            frames_written += (int(lens.sum()) if lens is not None
                               else int(np.prod(idx.shape[:-1])))
        ledger.mark_done(claim)
        worker = (worker + 1) % n_workers
    assert ledger.all_done
    return {"n_shards": len(batches), "n_written": n_written,
            "n_workers": n_workers, "wave": ledger.wave,
            "resumed": resumed, "frames_written": frames_written,
            "forward_s": forward_s, "write_s": write_s}


def run_shared_claims(ledger: WorkLedger, owner: str, batches, store,
                      engine, report: dict, *,
                      park_s: Optional[float] = None,
                      after_shard: Optional[Callable[[], None]] = None):
    """One writer's share of a shared-mode pass: race ``claim_shared``
    as ``owner``, forward each claimed batch through ``engine()`` (called
    once per range; it returns the engine, built on first use), commit
    its shard through the store's locked manifest path, then
    ``mark_done_shared``.  ``report`` collects the shards written
    (``shards``), the ranges claimed (``ranges``), their real frames and
    the seconds in forwards and in writes.  With nothing pending: return,
    or with ``park_s`` re-poll that often until the ledger is all done (a
    sibling's claims may come back).  ``after_shard()`` runs after each
    commit, before the range is marked done."""
    for key, zero in (("shards", []), ("ranges", []), ("frames_written", 0),
                      ("forward_s", 0.0), ("write_s", 0.0)):
        report.setdefault(key, zero)
    while True:
        claim = ledger.claim_shared(owner)
        if claim is None:
            ledger.refresh()
            if ledger.all_done or park_s is None:
                return
            time.sleep(park_s)          # park: claims may come back
            continue
        eng = engine()
        report["ranges"].append([claim.lo, claim.hi])
        for i in range(claim.lo, claim.hi):
            t0 = time.perf_counter()
            vals, idx = eng.forward_topk(batches[i])
            t1 = time.perf_counter()
            lens = _utt_lens_of(batches[i])
            store.append_shard(i, vals, idx, lens, wave=ledger.wave)
            report["forward_s"] += t1 - t0
            report["write_s"] += time.perf_counter() - t1
            report["shards"].append(i)
            report["frames_written"] += (
                int(lens.sum()) if lens is not None
                else int(np.prod(np.shape(idx)[:-1])))
            if after_shard is not None:
                after_shard()
        ledger.mark_done_shared(claim)


def generate_across_ranks(make_engine: Union[Callable[[int], object], str],
                          batches: Sequence[dict], store, *,
                          n_workers: int = 1, ledger_path: str,
                          processes: int = 0,
                          engine_kwargs: Optional[dict] = None,
                          crash: Optional[dict] = None,
                          supervisor_opts: Optional[dict] = None) -> Dict:
    """:func:`generate_sharded` split over the ranks of a
    ``runtime.cluster`` fleet (paper §3.2.2: target generation
    parallelized over machines), through the ledger's shared mode.

    Every rank calls it with the same batches and its own ``store``,
    opened ``shared=True`` under a fleet.  Rank 0 picks the wave
    (:func:`prepare_ledger`) and broadcasts it; then each rank races
    ``claim_shared`` as ``rank<i>``, its engine ``make_engine(rank)``
    built on its first claim, and commits its shards through the
    store's locked manifest path (:func:`run_shared_claims`, the worker
    processes' loop).  After a barrier every rank's ``store`` reloads
    the manifest.  Shards depend only on the batch and the engine, so
    the manifest and the shards are bitwise a one-process pass's,
    whichever rank wrote which.  Alone (no fleet) the one rank claims
    every range.

    ``processes=P`` (P >= 1, ``make_engine`` a ``"module:function"``
    spec called as ``factory(worker_id, engine_kwargs)``): each rank
    runs a ``runtime.workers`` Supervisor of P worker processes instead,
    rank 0 having staged the batches once; every rank's workers race the
    one ledger (owners, job, reports and logs carry the rank), a dead
    worker's claims are stolen once, and each supervisor returns when
    the whole ledger is done.  ``crash`` (which fires once a fleet,
    in the first rank's worker to reach it) and ``supervisor_opts`` pass
    through as in :func:`generate_sharded`.

    The report has :func:`generate_sharded`'s keys (``n_written``,
    ``frames_written``, ``forward_s`` and ``write_s`` summed over the
    ranks), ``ranges``, the ranges this rank generated, and ``ranks``,
    each rank's ``{"rank", "ranges", "n_written", "frames_written"}``;
    with ``processes`` also the fleet's ``processes``, ``restarts``,
    ``reclaimed`` (summed over the ranks), ``events`` (each with its
    ``rank``) and ``workers`` (every rank's workers' exit reports)."""
    from repro_torch.runtime import cluster
    fleet = cluster.world_size() > 1
    if fleet and not store.shared:
        raise ValueError("generate_across_ranks: under a fleet every rank "
                         "writes through a store opened shared=True")
    if processes:
        if not isinstance(make_engine, str):
            raise ValueError(
                "generate_across_ranks(processes=P) needs a "
                "'module:function' engine spec: a closure cannot cross a "
                "process boundary")
        resolve_engine_factory(make_engine)     # refuse before any ledger
    picked = None
    if cluster.is_leader():
        led = prepare_ledger(store, len(batches), n_workers,
                             ledger_path=ledger_path)
        picked = (led.wave, led.n_done > 0)
        if processes and fleet:
            from repro_torch.runtime.workers import stage_batches
            stage_batches(store, batches)
    wave, resumed = cluster.broadcast_object(picked)
    rank = cluster.active().process_index if fleet else 0
    ledger = WorkLedger.attach(ledger_path)
    mine: dict = {}
    if processes:
        from repro_torch.runtime.workers import run_supervised_generation
        fl = run_supervised_generation(
            ledger, batches, store, engine_spec=make_engine,
            engine_kwargs=engine_kwargs or {}, n_procs=processes,
            crash=crash, rank=rank if fleet else None,
            **(supervisor_opts or {}))
        mine = {k: fl[k] for k in ("processes", "restarts", "reclaimed",
                                   "workers", "frames_written", "forward_s",
                                   "write_s")}
        mine["events"] = [dict(e, rank=rank) for e in fl["events"]]
        mine["ranges"] = [r for w in fl["workers"] for r in w["ranges"]]
        mine["shards"] = [i for w in fl["workers"] for i in w["shards"]]
    else:
        built = []

        def engine():
            if not built:
                built.append(make_engine(rank))
            return built[0]
        run_shared_claims(ledger, f"rank{rank}", batches, store, engine,
                          mine)
    cluster.barrier()                   # every rank's commits are in
    store.reload()
    ledger.refresh()
    if not ledger.all_done:
        raise RuntimeError(f"the ranks finished with {ledger.n_done} of "
                           f"{len(ledger.ranges)} ranges done")
    mine.update(rank=rank, n_written=len(mine.pop("shards")))
    ranks = cluster.all_gather_object(mine)
    rep = {"n_shards": len(batches),
           "n_written": sum(r["n_written"] for r in ranks),
           "n_workers": n_workers, "wave": wave, "resumed": resumed,
           "frames_written": sum(r["frames_written"] for r in ranks),
           "forward_s": sum(r["forward_s"] for r in ranks),
           "write_s": sum(r["write_s"] for r in ranks),
           "ranges": mine["ranges"],
           "ranks": [{k: r[k] for k in ("rank", "ranges", "n_written",
                                        "frames_written")}
                     for r in ranks]}
    if processes:
        # the fleet's counts, as generate_sharded(processes=N) reports
        # them: every range's shards once
        rep["n_written"] = sum(r.hi - r.lo for r in ledger.ranges)
        for key in ("processes", "restarts", "reclaimed"):
            rep[key] = sum(r[key] for r in ranks)
        rep["events"] = [e for r in ranks for e in r["events"]]
        rep["workers"] = [w for r in ranks for w in r["workers"]]
    return rep


def generate_corpus(engine, store, utterances, *, shard_offset: int = 0,
                    wave_size: int = 0, store_wave: int = 0) -> List[str]:
    """The firehose path: raw (T, F) utterances -> bucketed batched
    inference -> one shard per utterance, numbered in submission order.
    Returns the shard paths (submission order).

    ``wave_size`` is the flush granularity (utterances per
    memory-bounded drain); ``store_wave`` the LogitStore generation tag
    — deliberately distinct names, because TeacherRunner's legacy
    ``wave`` argument means the former.

    ``utterances`` may be any iterable (including a generator — the
    1M-hour firehose is streamed, never materialized): work proceeds in
    waves of ``wave_size`` utterances (default: one policy batch), each
    wave's shards flushed to disk before the next is read, so host
    memory on both the input and output side stays bounded by one wave.

    Failure contract: if a wave's forward or a shard write raises, retry
    by re-running the *whole call* with the same corpus and
    shard_offset — shard contents are deterministic, so rewriting
    already-written shards is idempotent.  Each call is self-contained:
    stale work left queued by a failed call is discarded up front (its
    ordinals belong to that call's numbering).
    """
    wave_size = wave_size or engine.policy.max_batch
    engine.queue.discard_pending()
    engine.queue.pop_completed()
    it = iter(utterances)
    paths = {}
    j = 0
    while True:
        submitted = 0
        for u in it:
            engine.submit(u, meta={"ordinal": j})
            j += 1
            submitted += 1
            if submitted == wave_size:
                break
        if not submitted:
            break
        for r in engine.run().values():
            o = r.meta["ordinal"]
            paths[o] = store.append_shard(
                shard_offset + o, r.vals[None], r.idx[None],
                utt_lens=[r.vals.shape[0]], wave=store_wave)
    return [paths[o] for o in sorted(paths)]
