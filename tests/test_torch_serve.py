"""Port parity: the serving path (``StreamingEngine``, ``StreamServer``,
the launcher) against the JAX reference, plus the batcher, queue and slot
invariants of ``test_serve_engine.py`` / ``test_stream_server.py`` run
against the port.

The same weights and the same streams go through both packages.  The
served top-k must agree: ids exactly wherever the reference's logits
separate them by more than 1e-4 (the k-th from the (k+1)-th for the id
set, and each rank from its neighbours for its position), and values —
max-shifted, stored as bf16 — within one bf16 ulp.  Host-side counts
(syncs, steps, parks, units) must be equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.serve as jserve  # noqa: E402
import repro_torch.serve as pserve  # noqa: E402
from repro.configs.base import Segment as JaxSegment  # noqa: E402
from repro.core import logit_store as jax_logit_store  # noqa: E402
from repro.configs.lstm_am_7khr import CONFIG as JAX_CONFIG  # noqa: E402
from repro.configs.lstm_am_7khr import TEACHER as JAX_TEACHER  # noqa: E402
from repro.launch import serve as jax_launch  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.checkpoint import params_from_numpy  # noqa: E402
from repro_torch.configs import EncoderConfig, get_arch, reduced  # noqa: E402
from repro_torch.configs.base import Segment  # noqa: E402
from repro_torch.configs.lstm_am_7khr import CONFIG, TEACHER  # noqa: E402
from repro_torch.launch import serve as port_launch  # noqa: E402
from repro_torch.serve.request import InferenceRequest  # noqa: E402

F, V, K = 6, 25, 5
GAP = 1e-4
CPU = dict(device="cpu")


def _tiny(base, seg_cls):
    return base.replace(
        lstm_hidden=16, feat_dim=F, n_senones=V, vocab_size=V,
        segments=(seg_cls((base.segments[0].pattern[0],), repeat=2),))


class Pair:
    """One model in both packages, with the same weights."""

    def __init__(self, jbase, pbase, seed):
        self.jcfg, self.pcfg = _tiny(jbase, JaxSegment), _tiny(pbase, Segment)
        self.jm = jax_build_model(self.jcfg)
        self.jp = self.jm.init(jax.random.key(seed))
        self.pp = params_from_numpy(jax.device_get(self.jp), self.pcfg,
                                    device="cpu")
        self._logits = jax.jit(lambda p, x: self.jm.logits(p, x)[0])

    def logits(self, utt):
        """Reference full-utterance logits (T, V) for the gap checks."""
        return np.asarray(self._logits(self.jp, jnp.asarray(utt)[None])[0])


@pytest.fixture(scope="module")
def student():
    return Pair(JAX_CONFIG, CONFIG, 0)


@pytest.fixture(scope="module")
def teacher():
    return Pair(JAX_TEACHER, TEACHER, 1)


def _utts(rng, lens, scale=1.0):
    return [(rng.normal(size=(t, F)) * scale).astype(np.float32)
            for t in lens]


def _bf16_ulp(x):
    a = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(a)) - 7)


def assert_served_match(pv, pi, jv, ji, logits, k=K):
    """Port emissions (pv, pi) vs the reference's (jv, ji), (T, k) each;
    ``logits`` (T, V) are the reference's, for the near-tie gaps."""
    assert pv.shape == jv.shape == (logits.shape[0], k)
    assert pv.dtype == np.float32 and pi.dtype == np.int32
    top = -np.sort(-logits, axis=1)[:, :k + 1]
    clear = top[:, k - 1] - top[:, k] > GAP
    np.testing.assert_array_equal(np.sort(pi, 1)[clear],
                                  np.sort(ji, 1)[clear])
    gaps = -np.diff(top, axis=1)                         # (T, k)
    sep = gaps[:, :k] > GAP
    sep[:, 1:] &= gaps[:, :k - 1] > GAP
    np.testing.assert_array_equal(pi[sep], ji[sep])
    ulp = _bf16_ulp(np.maximum(np.abs(pv), np.abs(jv)))
    assert (np.abs(pv - jv) <= ulp).all(), np.abs(pv - jv).max()


# ------------------------------------------------- batch path vs reference

@pytest.mark.parametrize("kind,temp", [("student", 1.0), ("teacher", 1.0),
                                       ("student", 0.5)])
def test_engine_run_matches_jax(kind, temp, request):
    """Padded, bucketed batches (ragged lens sharing one batch shape)
    through both engines: the port's kernel emitter (its plain version
    on the CPU) vs the reference's codec path."""
    pair = request.getfixturevalue(kind)
    utts = _utts(np.random.default_rng(2), [11, 48, 23, 48, 5])
    pol = dict(max_batch=3, bucket_multiple=16)
    je = jserve.StreamingEngine(pair.jcfg, pair.jp, k=K, temperature=temp,
                                policy=jserve.BatchPolicy("t", **pol))
    pe = pserve.StreamingEngine(pair.pcfg, pair.pp, k=K, temperature=temp,
                                policy=pserve.BatchPolicy("t", **pol), **CPU)
    jrids = [je.submit(u) for u in utts]
    jres = je.run()
    prids = [pe.submit(u) for u in utts]
    pres = pe.run()
    assert pe.queue.drained and sorted(pres) == sorted(prids)
    for jrid, prid, u in zip(jrids, prids, utts):
        assert_served_match(pres[prid].vals, pres[prid].idx,
                            jres[jrid].vals, jres[jrid].idx,
                            pair.logits(u) / temp)


def test_forward_topk_mask_aware(teacher):
    """A pre-formed dict batch with a frame mask: the biLSTM backward
    pass must start at each row's last valid frame, as in the
    reference's dict path."""
    rng = np.random.default_rng(11)
    feats = rng.normal(size=(2, 32, F)).astype(np.float32)
    mask = np.zeros((2, 32), np.float32)
    mask[0, :32] = 1.0
    mask[1, :18] = 1.0
    pe = pserve.StreamingEngine(teacher.pcfg, teacher.pp, k=K, **CPU)
    vals, idx = pe.forward_topk({"feats": feats, "mask": mask})
    je = jserve.StreamingEngine(teacher.jcfg, teacher.jp, k=K)
    jv, ji = je.forward_topk({"feats": jnp.asarray(feats),
                              "mask": jnp.asarray(mask)})
    for b, n in ((0, 32), (1, 18)):
        assert_served_match(vals[b, :n].float().numpy(),
                            idx[b, :n].numpy(),
                            np.asarray(jv[b, :n], np.float32),
                            np.asarray(ji[b, :n]),
                            teacher.logits(feats[b, :n]))


# --------------------------------------------- streaming path vs reference

def _chunks(x0, x1, step=16):
    for lo in range(0, max(len(x0), len(x1)), step):
        c = {}
        if lo < len(x0):
            c[0] = x0[lo:lo + step]
        if lo < len(x1):
            c[1] = x1[lo:lo + step]
        yield c


def _collect(outs):
    got = {}
    for out in outs:
        for sid, (v, i) in out.items():
            got.setdefault(sid, []).append((v, i))
    return {sid: (np.concatenate([v for v, _ in p]),
                  np.concatenate([i for _, i in p])) for sid, p in got.items()}


@pytest.mark.parametrize("mode", ["feed", "feed_pipelined"])
def test_feed_matches_jax(student, mode):
    """Lockstep chunked streaming (ragged tails) through both engines."""
    x0, x1 = _utts(np.random.default_rng(4), [50, 37])
    je = jserve.StreamingEngine(student.jcfg, student.jp, k=K,
                                policy=jserve.LATENCY, n_slots=3)
    pe = pserve.StreamingEngine(student.pcfg, student.pp, k=K,
                                policy=pserve.LATENCY, n_slots=3, **CPU)
    for e in (je, pe):
        assert (e.open_stream(), e.open_stream()) == (0, 1)
    jgot = _collect(je.feed(c) for c in _chunks(x0, x1))
    if mode == "feed":
        pgot = _collect(pe.feed(c) for c in _chunks(x0, x1))
    else:
        pgot = _collect(pe.feed_pipelined(_chunks(x0, x1), depth=2))
    for sid, x in ((0, x0), (1, x1)):
        assert_served_match(*pgot[sid], *jgot[sid], student.logits(x))


def _tier_scenario(mod, cfg, params, **kw):
    """Firehose streams fill both slots; one is detached (state row to
    the host), two interactive streams arrive and park the other, then
    the detached one is reattached and everything drains."""
    tiers = mod.TieredPolicy((mod.INTERACTIVE, mod.FIREHOSE),
                             shed_threshold=0.5)
    srv = mod.StreamServer(cfg, params, n_slots=2, chunk_frames=4,
                           sync_every=2, k=K, tiers=tiers, **kw)
    rng = np.random.default_rng(21)
    fires = _utts(rng, [150, 131], 0.5)
    inters = _utts(rng, [8, 7], 0.5)
    rf = [srv.submit(u, tier="firehose") for u in fires]
    done = srv.pump()
    srv.detach(rf[0])
    ri = [srv.submit(u, tier="interactive") for u in inters]
    done.update(srv.pump())
    assert sorted(done) == sorted(ri)           # interactive done first
    srv.reattach(rf[0])
    done.update(srv.drain())
    return srv, rf + ri, fires + inters, done


def test_stream_server_drain_matches_jax(student):
    """StreamServer with SLO tiers, a detach/reattach and a park: the
    same emissions and the same host-side counts as the reference."""
    jsrv, jrids, utts, jdone = _tier_scenario(jserve, student.jcfg,
                                              student.jp)
    psrv, prids, _, pdone = _tier_scenario(pserve, student.pcfg,
                                           student.pp, **CPU)
    assert jrids == prids
    for rid, u in zip(prids, utts):
        pv, pi = pdone[rid].emissions()
        jv, ji = jdone[rid].emissions()
        assert_served_match(pv, pi, jv, ji, student.logits(u))
        assert pdone[rid].finished_sync == jdone[rid].finished_sync
    assert psrv.stats == jsrv.stats
    assert psrv.stats["parked"] == 2


def test_launch_serve_matches_jax(student, capsys):
    """The launcher's streaming scenario: same completion windows and
    emission counts as the reference CLI (weights differ; the schedule
    does not depend on them)."""
    pcfg = reduced(get_arch("lstm-am-7khr"))
    from repro.configs import get_arch as jget, reduced as jred
    jcfg = jred(jget("lstm-am-7khr"))
    jp = jax_build_model(jcfg).init(jax.random.key(0))
    pp = port_launch.build_model(
        pcfg, device="cpu",
        generator=torch.Generator().manual_seed(0)).state_dict()
    jd = jax_launch.serve_stream(jcfg, jp, n_streams=2)
    pd = port_launch.serve_stream(pcfg, pp, n_streams=2, device="cpu")
    assert sorted(jd) == sorted(pd)
    for r in jd:
        assert pd[r].finished_sync == jd[r].finished_sync
        assert pd[r].emissions()[0].shape == jd[r].emissions()[0].shape
    port_launch.main(["--arch", "lstm-am-teacher", "--device", "cpu",
                      "--requests", "2"])
    assert "2 utterances" in capsys.readouterr().out


# ---------------------------------------- invariants, run against the port

def _pengine(pair, **kw):
    return pserve.StreamingEngine(pair.pcfg, pair.pp, k=K, **CPU, **kw)


def _pserver(pair, **kw):
    kw.setdefault("k", K)
    return pserve.StreamServer(pair.pcfg, pair.pp, **CPU, **kw)


def _lockstep(pair, utt, chunk):
    """One solo stream through the port's lockstep open_stream/feed loop
    at the same chunk boundaries."""
    eng = _pengine(pair, n_slots=2)
    sid = eng.open_stream()
    outs = [eng.feed({sid: utt[c0:c0 + chunk]})
            for c0 in range(0, utt.shape[0], chunk)]
    eng.close_stream(sid)
    return _collect(outs)[sid]


def _assert_same(a, b):
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[0], b[0])


@pytest.mark.parametrize("policy", ["throughput", "latency"])
def test_batcher_covers_every_request_once(policy):
    pol = {"throughput": pserve.THROUGHPUT, "latency": pserve.LATENCY}[policy]
    rng = np.random.default_rng(0)
    reqs = [InferenceRequest(i, f) for i, f in
            enumerate(_utts(rng, [3, 70, 18, 129, 64, 1, 40]))]
    batches = pserve.form_batches(reqs, pol)
    assert sorted(r.rid for b in batches for r in b.requests) == \
        list(range(len(reqs)))
    for b in batches:
        assert b.feats.shape[0] == pol.max_batch
        assert b.feats.shape[1] % pol.bucket_multiple == 0
        for i, r in enumerate(b.requests):
            assert b.lens[i] == r.length
            np.testing.assert_array_equal(b.feats[i, :r.length], r.feats)
        assert (b.lens[b.n_real:] == 0).all()


def test_batcher_sorting_reduces_padding_and_counts_dead_rows():
    rng = np.random.default_rng(1)
    lens = [int(x) for pair in zip(rng.integers(5, 15, 40),
                                   rng.integers(200, 260, 40)) for x in pair]
    reqs = [InferenceRequest(i, np.zeros((t, F), np.float32))
            for i, t in enumerate(lens)]
    eff = {s: pserve.padding_efficiency(pserve.form_batches(
        reqs, pserve.BatchPolicy("t", max_batch=8, bucket_multiple=16,
                                 sort_by_length=s))) for s in (True, False)}
    assert eff[True] > eff[False]
    tail = pserve.form_batches(reqs[:6], pserve.BatchPolicy(
        "t", max_batch=4, bucket_multiple=16))
    assert [b.n_real for b in tail] == [4, 2]
    assert all(b.padded_frames == 4 * b.feats.shape[1] for b in tail)
    assert pserve.padding_efficiency(tail) == \
        sum(lens[:6]) / sum(b.padded_frames for b in tail)


def test_queue_ordering_and_completeness(student):
    rng = np.random.default_rng(6)
    utts = _utts(rng, list(rng.integers(1, 90, 17)))
    eng = _pengine(student, policy=pserve.BatchPolicy(
        "t", max_batch=4, bucket_multiple=16))
    rids = [eng.submit(u, meta={"n": i}) for i, u in enumerate(utts)]
    assert eng.queue.n_pending == len(utts)
    res = eng.run()
    assert eng.queue.drained and sorted(res) == sorted(rids)
    assert sorted(eng.queue.completion_order) == sorted(rids)
    for i, (rid, u) in enumerate(zip(rids, utts)):
        assert res[rid].vals.shape == res[rid].idx.shape == (len(u), K)
        assert res[rid].meta == {"n": i}
    more = [eng.submit(u) for u in _utts(rng, [12, 3])]
    assert sorted(eng.run()) == sorted(more)
    with pytest.raises(ValueError):
        eng.submit(np.zeros((4, F + 1), np.float32))


def test_run_failure_restores_pending(student):
    eng = _pengine(student, policy=pserve.BatchPolicy(
        "t", max_batch=2, bucket_multiple=16))
    rids = [eng.submit(u) for u in _utts(np.random.default_rng(9),
                                         [8, 21, 13])]
    good = eng._batch_forward

    def boom(*_a, **_kw):
        raise RuntimeError("injected forward failure")

    eng._batch_forward = boom
    with pytest.raises(RuntimeError):
        eng.run()
    assert eng.queue.n_pending == len(rids) and not eng.queue.drained
    eng._batch_forward = good
    assert sorted(eng.run()) == sorted(rids) and eng.queue.drained


def test_stream_slots_and_zero_frame_chunks(student):
    eng = _pengine(student, policy=pserve.LATENCY, n_slots=2)
    sid = eng.open_stream()
    with pytest.raises(ValueError, match="zero-frame"):
        eng.feed({sid: np.zeros((0, F), np.float32)})
    assert eng.feed({sid: np.zeros((3, F), np.float32)})[sid][0].shape == \
        (3, K)
    eng.close_stream(sid)
    calls = {"n": 0}
    real = eng._stream_forward

    def counting(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    eng._stream_forward = counting
    assert eng.feed({}) == {} and calls["n"] == 0
    with pytest.raises(ValueError):
        eng.feed({sid: np.zeros((3, F), np.float32)})   # closed
    with pytest.raises(ValueError):
        eng.close_stream(sid)                            # double close
    assert eng.open_stream() == sid                      # slots recycle
    pend = eng.feed_async({sid: np.zeros((2, F), np.float32)})
    assert pend.result() is pend.result()                # idempotent


def test_feed_pipelined_equals_sequential_feed(student):
    x0, x1 = _utts(np.random.default_rng(12), [50, 37])
    seq_e, pipe_e = (_pengine(student, policy=pserve.LATENCY, n_slots=3)
                     for _ in range(2))
    for e in (seq_e, pipe_e):
        e.open_stream(), e.open_stream()
    seq = [seq_e.feed(c) for c in _chunks(x0, x1)]
    pipe = list(pipe_e.feed_pipelined(_chunks(x0, x1), depth=2))
    assert len(seq) == len(pipe)
    for a, b in zip(seq, pipe):
        assert sorted(a) == sorted(b)
        for sid in a:
            _assert_same(a[sid], b[sid])


def test_stream_server_matches_lockstep(student):
    utts = _utts(np.random.default_rng(0), [23, 7, 40, 16, 31])
    srv = _pserver(student, n_slots=3, chunk_frames=8, sync_every=2)
    rids = [srv.submit(u) for u in utts]
    done = srv.drain()
    assert sorted(done) == sorted(rids)
    for rid, u in zip(rids, utts):
        assert done[rid].emissions()[0].shape == (u.shape[0], K)
        _assert_same(done[rid].emissions(), _lockstep(student, u, 8))
    assert srv.stats["useful_units"] == 23 + 7 + 40 + 16 + 31
    assert 0.0 < srv.utilization() <= 1.0


def test_detach_replace_reattach_bitwise(student):
    utt_a, utt_b = _utts(np.random.default_rng(2), [40, 12])
    solo = _pserver(student, n_slots=1, chunk_frames=8, sync_every=1)
    ra = solo.submit(utt_a)
    ref = solo.drain()[ra].emissions()
    srv = _pserver(student, n_slots=1, chunk_frames=8, sync_every=1)
    ra = srv.submit(utt_a)
    srv.pump()
    srv.pump()
    srv.detach(ra)
    assert srv.n_active == 0
    rb = srv.submit(utt_b)
    done = {}
    while rb not in done:
        done.update(srv.pump())
    _assert_same(done[rb].emissions(), _lockstep(student, utt_b, 8))
    srv.reattach(ra)
    _assert_same(srv.drain()[ra].emissions(), ref)
    assert srv.stats["parked"] == 1


def test_detach_requires_attachment_and_drain_refuses_held(student):
    srv = _pserver(student, n_slots=1, chunk_frames=4, sync_every=1)
    rid = srv.submit(_utts(np.random.default_rng(3), [12])[0])
    with pytest.raises(KeyError):
        srv.detach(rid)
    srv.pump()
    srv.detach(rid)
    with pytest.raises(RuntimeError, match="detached"):
        srv.drain()
    with pytest.raises(ValueError):
        srv.reattach(999)
    srv.reattach(rid)
    assert rid in srv.drain()


def test_live_append_close_matches_final_submit(student):
    (utt,) = _utts(np.random.default_rng(4), [24])
    ref = _pserver(student, n_slots=1, chunk_frames=8, sync_every=2)
    rr = ref.submit(utt)
    want = ref.drain()[rr].emissions()
    srv = _pserver(student, n_slots=1, chunk_frames=8, sync_every=2)
    rid = srv.submit(utt[:8], final=False)
    with pytest.raises(RuntimeError, match="open streams"):
        srv.drain()
    srv.pump()
    srv.pump()
    srv.append(rid, utt[8:])
    srv.close(rid)
    with pytest.raises(ValueError):
        srv.append(rid, utt[:8])
    done = {}
    while rid not in done:
        done.update(srv.pump())
    _assert_same(done[rid].emissions(), want)


def test_interactive_presence_tightens_window(student):
    fire, inter = _utts(np.random.default_rng(6), [64, 8])
    srv = _pserver(student, n_slots=2, chunk_frames=4, sync_every=8,
                   tiers=pserve.TieredPolicy((pserve.INTERACTIVE,
                                              pserve.FIREHOSE)))
    srv.submit(fire, tier="firehose")
    srv.pump()
    assert srv.stats["steps"] == 16
    srv.submit(inter, tier="interactive")
    srv.pump()
    assert srv.stats["steps"] == 16 + 2
    with pytest.raises(KeyError):
        srv.submit(inter, tier="bulk")


def test_firehose_parks_under_interactive_pressure(student):
    rng = np.random.default_rng(7)
    fires, inters = _utts(rng, [200, 200]), _utts(rng, [8, 8])
    srv = _pserver(student, n_slots=2, chunk_frames=4, sync_every=2,
                   tiers=pserve.TieredPolicy((pserve.INTERACTIVE,
                                              pserve.FIREHOSE),
                                             shed_threshold=0.5))
    rf = [srv.submit(u, tier="firehose") for u in fires]
    srv.pump()
    assert srv.occupancy()["firehose"] == 1.0
    ri = [srv.submit(u, tier="interactive") for u in inters]
    done2 = srv.pump()
    assert srv.stats["parked"] >= 1 and sorted(done2) == sorted(ri)
    done = srv.drain()
    done.update(done2)
    for rid, u in zip(rf + ri, fires + inters):
        _assert_same(done[rid].emissions(), _lockstep(student, u, 4))
    assert max(done[r].finished_sync for r in ri) < \
        max(done[r].finished_sync for r in rf)


def test_tier_max_batch_caps_occupancy(student):
    srv = _pserver(student, n_slots=3, chunk_frames=4, sync_every=4,
                   tiers=pserve.TieredPolicy((
                       pserve.SLOTier("interactive", sync_every=2),
                       pserve.SLOTier("firehose", sync_every=4, max_batch=1,
                                      preemptible=True))))
    for u in _utts(np.random.default_rng(8), [40, 40, 40]):
        srv.submit(u, tier="firehose")
    srv.pump()
    assert srv._tier_counts().get("firehose", 0) == 1
    assert len(srv.drain()) == 3


def test_frame_utilization_counts_padding_and_dead_rows(student):
    srv = _pserver(student, n_slots=4, chunk_frames=8, sync_every=2)
    rid = srv.submit(_utts(np.random.default_rng(9), [10])[0])
    assert rid in srv.drain()
    assert srv.stats["padded_units"] == 4 * 2 * 8
    assert srv.stats["useful_units"] == 10
    assert srv.utilization() == 10 / 64
    assert pserve.padding_efficiency(srv.stats) == srv.utilization()


def test_abort_recovers_streams(student):
    (utt,) = _utts(np.random.default_rng(10), [16])
    srv = _pserver(student, n_slots=2, chunk_frames=4, sync_every=1)
    rid = srv.submit(utt)
    srv.pump()
    orig = srv._run_window

    def boom(k):
        raise RuntimeError("injected")

    srv._run_window = boom
    with pytest.raises(RuntimeError, match="injected"):
        srv.pump()
    srv._run_window = orig
    assert srv.n_active == 0 and srv.queue.n_pending == 1
    _assert_same(srv.drain()[rid].emissions(), _lockstep(student, utt, 4))


def test_submit_validates(student, teacher):
    srv = _pserver(student, n_slots=1, chunk_frames=4, sync_every=1)
    with pytest.raises(ValueError):
        srv.submit(np.zeros((4, F + 1), np.float32))
    with pytest.raises(ValueError):
        srv.submit(np.zeros((0, F), np.float32))
    with pytest.raises(ValueError, match="streaming"):
        pserve.StreamServer(teacher.pcfg, teacher.pp, n_slots=1, **CPU)
    with pytest.raises(ValueError, match="bidirectional"):
        pserve.StreamingEngine(teacher.pcfg, teacher.pp, **CPU).open_stream()
    whisper_like = student.pcfg.replace(family="audio",
                                        encoder=EncoderConfig(n_layers=2))
    with pytest.raises(NotImplementedError, match="not ported yet"):
        pserve.StreamServer(whisper_like, student.pp, **CPU)


def test_topk_emitters_agree_and_emit_wire_format():
    x = torch.from_numpy(np.random.default_rng(7).normal(
        size=(3, 40, 100)).astype(np.float32) * 3)
    x[0, :, :50] = torch.round(x[0, :, :50])        # ties in row 0
    kv, ki = pserve.make_topk_emitter(7, "kernel")(x)
    jv, ji = jax_logit_store.topk_compress(jnp.asarray(x.numpy()), 7)
    assert kv.dtype == torch.bfloat16 and ki.dtype == torch.int32
    np.testing.assert_array_equal(ki.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(kv.float().numpy(),
                                  np.asarray(jv.astype(jnp.float32)))
    assert (kv[..., 0] == 0).all()                  # max shifted to 0
    for impl in ("lax", "sort"):
        with pytest.raises(ValueError, match="unknown topk impl"):
            pserve.make_topk_emitter(7, impl)

