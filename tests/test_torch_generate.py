"""Port parity: sharded target generation (``pipeline/generate.py``), its
work ledger and process primitives (``runtime/procs.py``), the teacher's
generation paths and ``distill_shard_source`` over the v2 store, against
the JAX reference.

The reference's pipeline cases (``tests/test_pipeline.py``) run through
both packages' ``generate_sharded`` with the same deterministic engine:
the stores and ledgers they leave are byte-identical.  The ledger's JSON
after the same claim / done / kill / reopen sequence equals the
reference's (``claim_ts`` aside).  A reduced teacher with the reference's
weights writes the same shards through both packages: ids equal away
from near-ties, values within one bf16 ulp.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.base import LayerSpec as JaxLayerSpec  # noqa: E402
from repro.configs.base import Segment as JaxSegment  # noqa: E402
from repro.configs.lstm_am_7khr import TEACHER as JAX_TEACHER  # noqa: E402
from repro.core.teacher import TeacherRunner as JaxTeacherRunner  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro import pipeline as jpipe  # noqa: E402
from repro import store as jstore  # noqa: E402
from repro import train as jtrain  # noqa: E402
from repro_torch import pipeline as ppipe  # noqa: E402
from repro_torch import store as pstore  # noqa: E402
from repro_torch import train as ptrain  # noqa: E402
from repro_torch.checkpoint import params_from_numpy  # noqa: E402
from repro_torch.configs.base import LayerSpec, Segment  # noqa: E402
from repro_torch.configs.lstm_am_7khr import TEACHER  # noqa: E402
from repro_torch.core.teacher import TeacherRunner  # noqa: E402
from repro_torch.runtime import procs  # noqa: E402
from repro_torch.serve import BatchPolicy  # noqa: E402
from repro_torch.train import data as ptrain_data  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
K, V = 4, 30
PKGS = {"jax": (jpipe, jstore), "port": (ppipe, pstore)}


class _FakeEngine:
    """The reference test's deterministic stand-in for an engine: top-k
    of a fixed random projection of the batch — content depends only on
    the batch, never on which worker ran it."""

    def __init__(self, worker: int, calls: list):
        self.worker = worker
        self.calls = calls

    def forward_topk(self, batch):
        self.calls.append(self.worker)
        feats = np.asarray(batch["feats"], np.float32)
        w = np.random.default_rng(0).normal(
            size=(feats.shape[-1], V)).astype(np.float32)
        logits = feats @ w
        idx = np.argsort(-logits, axis=-1)[..., :K].astype(np.int32)
        vals = np.take_along_axis(logits, idx, axis=-1)
        return vals - vals[..., :1], idx


class _DyingEngine(_FakeEngine):
    def forward_topk(self, batch):
        if len(self.calls) == 3:
            raise RuntimeError("worker killed")
        return super().forward_topk(batch)


def _batches(n, b=2, s=5, f=8):
    rng = np.random.default_rng(3)
    out = []
    for _ in range(n):
        mask = np.ones((b, s), np.float32)
        mask[1, 3:] = 0.0
        out.append({"feats": rng.normal(size=(b, s, f)).astype(np.float32),
                    "mask": mask})
    return out


def _files(root) -> dict:
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


def _assert_same_trees(a, b):
    fa, fb = _files(a), _files(b)
    assert sorted(fa) == sorted(fb)
    for rel in fa:
        assert fa[rel] == fb[rel], rel


# -------------------------------------------------------------- ledger

def test_shard_ranges_match_jax():
    for n in range(0, 30, 3):
        for w in (1, 2, 3, 5, 8):
            assert ppipe.shard_ranges(n, w) == jpipe.shard_ranges(n, w)
    with pytest.raises(ValueError):
        ppipe.shard_ranges(4, 0)


def _ledger_json(path) -> dict:
    with open(path) as f:
        d = json.load(f)
    for r in d["ranges"]:
        r["claim_ts"] = None if r["claim_ts"] is None else "set"
    return d


def test_ledger_transitions_match_jax(tmp_path):
    """Claim, done, kill (reopen demotes the live claim), resume, and the
    shared mode's claims: after every step each package's ledger file
    holds the reference's JSON (``claim_ts`` aside)."""
    ranges = [(0, 2), (2, 4), (4, 6)]
    paths = {n: str(tmp_path / n / "ledger.json") for n in PKGS}
    led = {n: p.WorkLedger.open(paths[n], ranges, wave=3)
           for n, (p, _) in PKGS.items()}

    def same():
        assert _ledger_json(paths["jax"]) == _ledger_json(paths["port"])

    same()
    got = {n: (l.claim("w0"), l.claim("w1")) for n, l in led.items()}
    same()
    for n, l in led.items():
        l.mark_done(got[n][0])
    same()
    led = {n: p.WorkLedger.open(paths[n], ranges)
           for n, (p, _) in PKGS.items()}                   # killed: reopen
    same()
    for n, l in led.items():
        assert [r.status for r in l.ranges] == ["done", "pending", "pending"]
        assert l.wave == 3 and l.n_done == 1 and not l.all_done
        c = l.claim("w0")
        assert (c.lo, c.hi) == (2, 4)
        l.mark_done(c)
    same()
    shared = {n: p.WorkLedger.attach(paths[n]) for n, (p, _) in PKGS.items()}
    claims = {n: l.claim_shared("p1") for n, l in shared.items()}
    for n, l in shared.items():
        assert (claims[n].lo, claims[n].hi) == (4, 6)
        assert l.claim_shared("p2") is None
    same()
    for n, l in shared.items():
        l.mark_done_shared(claims[n])
        assert l.all_done and PKGS[n][0].WorkLedger.peek_all_done(paths[n])
    same()
    with open(paths["port"]) as f, open(paths["jax"]) as g:
        assert f.read() == g.read()
    with pytest.raises(ValueError, match="repartition"):
        ppipe.WorkLedger.open(paths["port"], [(0, 6)])


def test_ledger_shared_across_packages(tmp_path):
    """One ledger file, claimed alternately by a reference and a port
    ledger in shared mode: every range is claimed once, under one lock."""
    path = str(tmp_path / "ledger.json")
    jpipe.WorkLedger.open(path, jpipe.shard_ranges(8, 8))
    leds = [jpipe.WorkLedger.attach(path), ppipe.WorkLedger.attach(path)]
    claims = []
    for i in range(10):
        c = leds[i % 2].claim_shared(f"o{i % 2}")
        if c is not None:
            claims.append((c.lo, c.hi))
            leds[(i + 1) % 2].mark_done_shared(c)
    assert sorted(claims) == jpipe.shard_ranges(8, 8)
    assert ppipe.WorkLedger.attach(path).all_done


_RACER = """
import json, sys
pkg = sys.argv[4]
if pkg == "port":
    from repro_torch.pipeline.generate import WorkLedger
else:
    from repro.pipeline.generate import WorkLedger
led = WorkLedger.attach(sys.argv[1])
owner, out = sys.argv[2], []
while True:
    c = led.claim_shared(owner)
    if c is None:
        break
    out.append([c.lo, c.hi])
    led.mark_done_shared(c)
json.dump(out, open(sys.argv[3], "w"))
"""


def test_processes_race_claims_disjointly(tmp_path):
    """More processes than cores, half of them the reference's ledger and
    half the port's, race claim_shared on one file: every range is
    claimed exactly once (a lost update under the lock would claim one
    twice or leave one pending)."""
    path = str(tmp_path / "ledger.json")
    ranges = ppipe.shard_ranges(60, 60)
    ppipe.WorkLedger.open(path, ranges)
    n = max(10, (os.cpu_count() or 1) + 2)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    ps = [subprocess.Popen(
        [sys.executable, "-c", _RACER, path, f"p{i}",
         str(tmp_path / f"claims{i}.json"), ("port", "jax")[i % 2]],
        env=env) for i in range(n)]
    try:
        for p in ps:
            assert p.wait(timeout=120) == 0
    finally:
        for p in ps:
            if p.poll() is None:
                p.kill()
    claims = []
    for i in range(n):
        with open(tmp_path / f"claims{i}.json") as f:
            claims += [tuple(c) for c in json.load(f)]
    assert sorted(claims) == ranges
    assert ppipe.WorkLedger.attach(path).all_done


def _open_shared(tmp_path):
    return ppipe.WorkLedger.open(str(tmp_path / "ledger.json"),
                                 ppipe.shard_ranges(8, 4))


def test_reclaim_stale_by_heartbeat_age(tmp_path):
    led = _open_shared(tmp_path)
    procs.beat(led.heartbeat_dir, "a")
    claim = led.claim_shared("a")
    assert led.reclaim_stale(max_age_s=5.0) == []
    hb = procs.heartbeat_path(led.heartbeat_dir, "a")
    past = time.time() - 60
    os.utime(hb, (past, past))
    stolen = led.reclaim_stale(max_age_s=5.0)
    assert [(r.lo, r.hi) for r in stolen] == [(claim.lo, claim.hi)]
    assert led.events[-1]["mode"] == "hb_age" and led.events[-1]["from"] == "a"
    led.refresh()
    assert led.ranges[0].status == "pending"
    assert led.claim_shared("b") is not None


def test_reclaim_stale_never_beat_and_claim_age(tmp_path):
    led = _open_shared(tmp_path)
    led.claim_shared("ghost")                       # no beat ever
    assert led.reclaim_stale(max_age_s=5.0) == []   # too young
    stolen = led.reclaim_stale(max_age_s=5.0, now=time.time() + 60)
    assert len(stolen) == 1 and led.events[-1]["mode"] == "never_beat"
    # a live heartbeat but a claim older than claim_timeout_s
    procs.beat(led.heartbeat_dir, "hung")
    led.claim_shared("hung")
    assert led.reclaim_stale(max_age_s=5.0) == []
    stolen = led.reclaim_stale(max_age_s=1e9, claim_timeout_s=30.0,
                               now=time.time() + 60)
    assert [r.owner for r in stolen] == ["hung"]
    assert led.events[-1]["mode"] == "claim_age"


def test_reclaim_stale_owner_fast_path(tmp_path):
    led = _open_shared(tmp_path)
    procs.beat(led.heartbeat_dir, "dead")
    procs.beat(led.heartbeat_dir, "live")
    led.claim_shared("dead")
    keep = led.claim_shared("live")
    stolen = led.reclaim_stale(max_age_s=0.0, owners=["dead"])
    assert len(stolen) == 1 and stolen[0].owner == "dead"
    led.refresh()
    by_range = {(r.lo, r.hi): r for r in led.ranges}
    assert by_range[(keep.lo, keep.hi)].status == "claimed"
    assert by_range[(keep.lo, keep.hi)].owner == "live"


def test_mark_done_shared_idempotent_and_strict(tmp_path):
    led = _open_shared(tmp_path)
    claim = led.claim_shared("a")
    led.mark_done_shared(claim)
    led.mark_done_shared(claim)                     # stolen, finished twice
    led.refresh()
    assert led.n_done == 1
    with pytest.raises(ValueError):
        led.mark_done_shared(ppipe.WorkRange(100, 200))


# ---------------------------------------------------------------- procs

def test_file_lock_excludes_second_holder(tmp_path):
    lock = str(tmp_path / "x.lock")
    with procs.file_lock(lock):
        t0 = time.monotonic()
        with pytest.raises(TimeoutError):
            with procs.file_lock(lock, timeout_s=0.2, poll_s=0.02):
                pass
        assert time.monotonic() - t0 >= 0.2
    with procs.file_lock(lock, timeout_s=0.2):      # released: re-acquirable
        pass


def test_heartbeat_thread_and_age(tmp_path):
    hb = str(tmp_path / "hb")
    assert procs.heartbeat_age(hb, "w") is None     # never beat
    with procs.Heartbeat(hb, "w", interval_s=0.05) as h:
        age0 = procs.heartbeat_age(hb, "w")
        assert age0 is not None and age0 < 1.0
        time.sleep(0.2)
        assert h._thread.is_alive()
    assert h._thread is None
    path = procs.heartbeat_path(hb, "w")
    past = time.time() - 60
    os.utime(path, (past, past))
    assert procs.heartbeat_age(hb, "w") > 30


def test_crash_point_disarmed_and_armed():
    cp = procs.CrashPoint(after=None)
    for _ in range(100):
        cp.tick()
    code = ("from repro_torch.runtime.procs import CrashPoint\n"
            "cp = CrashPoint(after=1)\n"
            "cp.tick(); print('one', flush=True)\n"
            "cp.tick()\n"
            "print('unreachable', flush=True)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == -9
    assert "one" in out.stdout and "unreachable" not in out.stdout


# ------------------------------------------- generate_sharded, both packages

def _run_both(tmp_path, scenario):
    """Run ``scenario(pipeline, store_pkg, root)`` once per package in its
    own root; the trees they leave must be byte-identical."""
    out = {}
    for name, (pipe, st) in PKGS.items():
        root = str(tmp_path / name)
        out[name] = scenario(pipe, st, root)
    _assert_same_trees(str(tmp_path / "jax"), str(tmp_path / "port"))
    return out


def test_generate_sharded_two_workers_single_consumer(tmp_path):
    batches = _batches(6)

    def scenario(pipe, st, root):
        calls = []
        store2 = st.LogitStoreV2(os.path.join(root, "w2"), k=K, vocab=V)
        rep = pipe.generate_sharded(lambda w: _FakeEngine(w, calls),
                                    batches, store2, n_workers=2)
        assert rep["n_shards"] == 6 and rep["n_workers"] == 2
        assert set(calls) == {0, 1} and store2.verify() == 6
        store1 = st.LogitStoreV2(os.path.join(root, "w1"), k=K, vocab=V)
        pipe.generate_sharded(lambda w: _FakeEngine(w, []), batches, store1,
                              n_workers=1)
        for j in range(6):
            v2, i2 = store2.read_shard(j, verify=True)
            v1, i1 = store1.read_shard(j)
            np.testing.assert_array_equal(i2, i1)
            np.testing.assert_array_equal(v2, v1)
            np.testing.assert_array_equal(store2.read_lens(j), [5, 3])
        return rep

    reps = _run_both(tmp_path, scenario)
    port = reps["port"]
    assert {k: port[k] for k in reps["jax"]} == reps["jax"]
    assert port["frames_written"] == 6 * 8
    assert port["forward_s"] >= 0 and port["write_s"] > 0


def test_generate_sharded_resumes_killed_range(tmp_path):
    batches = _batches(6)

    def scenario(pipe, st, root):
        store = st.LogitStoreV2(root, k=K, vocab=V)
        lp = os.path.join(root, "ledger.json")
        calls = []
        with pytest.raises(RuntimeError, match="killed"):
            pipe.generate_sharded(lambda w: _DyingEngine(w, calls), batches,
                                  store, n_workers=2, ledger_path=lp)
        assert 0 < len(store.shards()) < 6
        assert store.verify() == len(store.shards())
        led = pipe.WorkLedger.open(lp, pipe.shard_ranges(6, 2))
        assert led.n_done == 1
        calls2 = []
        rep = pipe.generate_sharded(lambda w: _FakeEngine(w, calls2),
                                    batches, store, n_workers=2,
                                    ledger_path=lp)
        assert rep["resumed"] and store.verify() == 6
        assert store.shards() == list(range(6))
        assert len(calls2) == 3 and rep["n_written"] == 3
        assert all(store.manifest.entry(j).wave == 0 for j in range(6))
        return rep

    _run_both(tmp_path, scenario)


def test_generate_sharded_rerun_supersedes_wave(tmp_path):
    batches = _batches(4)

    def scenario(pipe, st, root):
        store = st.LogitStoreV2(root, k=K, vocab=V)
        r0 = pipe.generate_sharded(lambda w: _FakeEngine(w, []), batches,
                                   store, n_workers=2)
        r1 = pipe.generate_sharded(lambda w: _FakeEngine(w, []), batches,
                                   store, n_workers=2)
        assert r0["wave"] == 0 and r1["wave"] == 1
        assert all(store.manifest.entry(j).wave == 1 for j in store.shards())
        assert len(store.manifest.retired) == 4
        store.verify()
        return r1

    _run_both(tmp_path, scenario)


def test_generate_sharded_completed_pass_repartitions(tmp_path):
    batches = _batches(6)

    def scenario(pipe, st, root):
        store = st.LogitStoreV2(root, k=K, vocab=V)
        lp = os.path.join(root, "ledger.json")
        pipe.generate_sharded(lambda w: _FakeEngine(w, []), batches, store,
                              n_workers=2, ledger_path=lp)
        rep = pipe.generate_sharded(lambda w: _FakeEngine(w, []), batches,
                                    store, n_workers=3, ledger_path=lp)
        assert rep["n_workers"] == 3 and rep["wave"] == 1
        assert store.verify() == 6
        return rep

    _run_both(tmp_path, scenario)


def test_generate_sharded_fresh_ledger_respects_live_wave(tmp_path):
    batches = _batches(4)

    def scenario(pipe, st, root):
        store = st.LogitStoreV2(root, k=K, vocab=V)
        lp = os.path.join(root, "ledger.json")
        for _ in range(2):
            pipe.generate_sharded(lambda w: _FakeEngine(w, []), batches,
                                  store, n_workers=2, ledger_path=lp)
        os.remove(lp)
        rep = pipe.generate_sharded(lambda w: _FakeEngine(w, []), batches,
                                    store, n_workers=1, ledger_path=lp)
        assert rep["wave"] == 2
        store.verify()
        return rep

    _run_both(tmp_path, scenario)


def test_generate_sharded_processes_not_ported(tmp_path):
    store = pstore.LogitStoreV2(str(tmp_path), k=K, vocab=V)
    with pytest.raises(NotImplementedError, match="step 8"):
        ppipe.generate_sharded("m:f", _batches(2), store, processes=1)
    assert not os.path.exists(os.path.join(str(tmp_path),
                                           "gen_ledger.json"))
    from repro_torch.pipeline.generate import resolve_engine_factory
    assert resolve_engine_factory("os.path:join") is os.path.join
    with pytest.raises(ValueError, match="module:function"):
        resolve_engine_factory("nocolon")
    assert sorted(ppipe.__all__) == sorted(jpipe.__all__)


# --------------------------------------------------- the teacher, end to end

def _teacher_pair():
    def cfg(base, seg, spec):
        return base.replace(
            lstm_hidden=16, feat_dim=6, n_senones=V, vocab_size=V,
            segments=(seg((spec(mixer="bilstm", ffn="none"),), repeat=2),))
    jcfg = cfg(JAX_TEACHER, JaxSegment, JaxLayerSpec)
    pcfg = cfg(TEACHER, Segment, LayerSpec)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.key(5))
    return jcfg, jm, jp, pcfg, params_from_numpy(jax.device_get(jp), pcfg,
                                                 device="cpu")


def _bf16_ulp(x):
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


def _assert_topk_match(pv, pi, jv, ji, logits, k):
    """ids equal where the reference's logits separate them by > 1e-4,
    values within one bf16 ulp."""
    pv, jv = (np.asarray(a, np.float32).reshape(-1, k) for a in (pv, jv))
    pi, ji = (np.asarray(a).reshape(-1, k) for a in (pi, ji))
    top = -np.sort(-logits.reshape(-1, logits.shape[-1]), axis=1)[:, :k + 1]
    gaps = -np.diff(top, axis=1)
    sep = gaps[:, :k] > 1e-4
    sep[:, 1:] &= gaps[:, :k - 1] > 1e-4
    np.testing.assert_array_equal(pi[sep], ji[sep])
    assert (np.abs(pv - jv) <= _bf16_ulp(np.maximum(np.abs(pv),
                                                    np.abs(jv)))).all()


def test_teacher_generate_sharded_matches_jax(tmp_path):
    """A reduced biLSTM teacher with the reference's weights through each
    package's generate_sharded (2 workers, ragged masks): the manifests
    agree in everything but the value bytes, and the shards match."""
    jcfg, jm, jp, pcfg, pp = _teacher_pair()
    rng = np.random.default_rng(6)
    batches = []
    for _ in range(3):
        lens = rng.integers(3, 10, 3)
        mask = (np.arange(9)[None] < lens[:, None]).astype(np.float32)
        batches.append({"feats": rng.normal(size=(3, 9, 6)).astype(
            np.float32) * mask[..., None], "mask": mask})
    js = jstore.LogitStoreV2(str(tmp_path / "j"), k=K, vocab=V)
    ps = pstore.LogitStoreV2(str(tmp_path / "p"), k=K, vocab=V)
    jrep = jpipe.generate_sharded(lambda w: JaxTeacherRunner(jcfg, jp, k=K),
                                  batches, js, n_workers=2)
    prep = ppipe.generate_sharded(
        lambda w: TeacherRunner(pcfg, pp, k=K, device="cpu"), batches, ps,
        n_workers=2)
    assert {k: prep[k] for k in jrep} == jrep
    assert prep["frames_written"] == sum(int(b["mask"].sum())
                                         for b in batches)
    assert js.verify() == ps.verify() == 3
    jm_, pm_ = js.manifest, ps.manifest
    assert (pm_.k, pm_.vocab, pm_.shard_ids()) == (jm_.k, jm_.vocab,
                                                   jm_.shard_ids())
    for j, b in enumerate(batches):
        je, pe = jm_.entry(j), pm_.entry(j)
        assert (pe.wave, pe.n_frames, pe.k, pe.vocab, pe.files) == \
            (je.wave, je.n_frames, je.k, je.vocab, je.files)
        np.testing.assert_array_equal(ps.read_lens(j), js.read_lens(j))
        np.testing.assert_array_equal(ps.read_lens(j), b["mask"].sum(-1))
        lens = b["mask"].sum(-1).astype(np.int32)
        h, _ = jm.apply(jp, b["feats"], lens=lens)
        logits = np.asarray(jm.unembed(jp, h))
        _assert_topk_match(*ps.read_shard(j), *js.read_shard(j), logits, K)


def test_teacher_generate_corpus_to_store_matches_jax(tmp_path):
    """The firehose: ragged utterances, flushed in waves of 3, one shard
    per utterance in submission order through both packages."""
    jcfg, jm, jp, pcfg, pp = _teacher_pair()
    rng = np.random.default_rng(7)
    utts = [rng.normal(size=(int(t), 6)).astype(np.float32)
            for t in rng.integers(2, 20, 7)]
    pol = dict(max_batch=3, bucket_multiple=8)
    js = jstore.LogitStoreV2(str(tmp_path / "j"), k=K, vocab=V)
    ps = pstore.LogitStoreV2(str(tmp_path / "p"), k=K, vocab=V)
    from repro.serve import BatchPolicy as JaxBatchPolicy
    jr = JaxTeacherRunner(jcfg, jp, k=K, policy=JaxBatchPolicy("t", **pol))
    pr = TeacherRunner(pcfg, pp, k=K, policy=BatchPolicy("t", **pol),
                       device="cpu")
    assert pr.forward_topk == pr.generate
    jpaths = jr.generate_corpus_to_store(js, iter(utts), shard_offset=10,
                                         wave=3, store_wave=2)
    ppaths = pr.generate_corpus_to_store(ps, iter(utts), shard_offset=10,
                                         wave=3, store_wave=2)
    assert [os.path.relpath(p, ps.root) for p in ppaths] == \
        [os.path.relpath(p, js.root) for p in jpaths]
    assert ps.shards() == list(range(10, 17)) and ps.verify() == 7
    for j, u in enumerate(utts):
        pe, je = ps.manifest.entry(10 + j), js.manifest.entry(10 + j)
        assert pe.n_frames == je.n_frames == len(u) and pe.wave == 2
        np.testing.assert_array_equal(ps.read_lens(10 + j), [len(u)])
        h, _ = jm.apply(jp, u[None])
        logits = np.asarray(jm.unembed(jp, h))
        _assert_topk_match(*ps.read_shard(10 + j), *js.read_shard(10 + j),
                           logits, K)


# ------------------------------------------------ distill_shard_source on v2

def _filled_store(st, root):
    store = st.LogitStoreV2(root, k=K, vocab=V)
    old = {}
    rng = np.random.default_rng(5)
    for j in range(4):
        vals = rng.normal(size=(2, 5, K)).astype(np.float32)
        vals = vals - vals.max(-1, keepdims=True)
        idx = rng.integers(0, V, (2, 5, K)).astype(np.int32)
        store.append_shard(j, vals, idx)
        old[j] = idx
    return store, old


def test_distill_source_pin_wave_survives_mid_epoch_supersede(tmp_path):
    """Pinned, both packages feed every batch its wave-0 targets through
    a regeneration landing after the second batch; unpinned, both switch
    to the new wave half way through, as the reference does."""
    batches = _batches(4)
    for name, (_, st) in PKGS.items():
        src = jtrain if name == "jax" else ptrain
        store, old = _filled_store(st, str(tmp_path / name))
        it = iter(src.distill_shard_source(batches, store, 0, 4, 0.1,
                                           pin_wave=True, verify=True))
        got = [next(it), next(it)]
        for j in range(4):
            store.append_shard(j, np.zeros((2, 5, K), np.float32),
                               np.full((2, 5, K), j % V, np.int32), wave=1)
        got += list(it)
        for j, tb in enumerate(got):
            np.testing.assert_array_equal(np.asarray(tb.data["topk_idx"]),
                                          old[j], err_msg=f"{name} {j}")
        it = iter(src.distill_shard_source(batches, store, 0, 4, 0.1))
        first = next(it)
        for j in range(4):
            store.append_shard(j, np.zeros((2, 5, K), np.float32),
                               np.full((2, 5, K), (j + 7) % V, np.int32),
                               wave=2)
        rest = list(it)
        assert np.asarray(first.data["topk_idx"]).max() == 0    # wave 1
        assert np.asarray(rest[0].data["topk_idx"]).max() == 8  # wave 2


def test_distill_source_verify_raises_on_corrupted_shard(tmp_path):
    batches = _batches(4)
    for name, (_, st) in PKGS.items():
        src = jtrain if name == "jax" else ptrain
        store, _ = _filled_store(st, str(tmp_path / name))
        path = os.path.join(store.root, store.manifest.entry(2).files["idx"])
        with open(path, "r+b") as f:
            f.seek(os.path.getsize(path) - 4)
            f.write(b"\xff\xff\xff\xff")
        for pin in (False, True):
            it = iter(src.distill_shard_source(batches, store, 0, 4, 0.1,
                                               verify=True, pin_wave=pin))
            assert len([next(it), next(it)]) == 2
            with pytest.raises(src is jtrain and jstore.ShardCorruptionError
                               or pstore.ShardCorruptionError):
                next(it)
        assert len(list(src.distill_shard_source(batches, store, 0, 4,
                                                 0.1))) == 4


def test_distill_source_copies_v2_reads_into_tensors(tmp_path):
    """A v2 read (a read-only memory map) becomes host tensors, copied
    once and counted; no not-writable warning reaches the loss; the
    values are the stored float16."""
    import warnings
    batches = _batches(4)
    store, old = _filled_store(pstore, str(tmp_path))
    ptrain_data.SHARD_COPIES = 0
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        items = list(ptrain.distill_shard_source(batches, store, 1, 9, 0.1,
                                                 pin_wave=True))
        for tb in items:
            torch.as_tensor(tb.data["topk_vals"])
    assert ptrain_data.SHARD_COPIES == 3 and len(items) == 3
    for j, tb in zip((1, 2, 3), items):
        assert tb.data["topk_vals"].dtype == torch.float16
        assert tb.data["topk_idx"].dtype == torch.int32
        np.testing.assert_array_equal(tb.data["topk_idx"].numpy(), old[j])
        np.testing.assert_array_equal(tb.data["topk_vals"].numpy(),
                                      store.read_shard(j)[0])
