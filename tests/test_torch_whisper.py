"""Port parity: whisper (``models/whisper.py``) and its serving path
against the JAX reference, on ``reduced(whisper-medium)`` (d_model 256,
4 heads of 64, 2 encoder layers, 1 decoder layer, vocab 512; one test
family also repeats the decoder layer, since one layer cannot show a
per-layer mix-up).

The same weights (drawn by JAX, carried over by ``checkpoint/convert.py``)
and the same inputs (numpy, seeded) go through both packages.  Bars:
  * float tensors (hidden states, caches, streaming buffers) within
    ``REL`` = 1e-5 of max(1, |reference|), elementwise;
  * logits within ``REL`` of max(1, the row's largest |reference|): the
    tied unembedding is a D-term product of an N(0, 1) table with
    layer-normed states, logits reach ~160 at D = 256, and float32
    rounding of the same product in another order alone moves a logit
    near 0 by ~6e-5 (measured: the port's ``unembed`` of the
    reference's own hidden states);
  * integer state (``pos``, ``enc_len``, the fed-back ``tok``) and
    greedy tokens equal;
  * served top-k: ids equal, max-shifted bf16 values within one bf16
    ulp of the reference's;
  * the port against itself (detach and reattach, a slot reused in
    ``StreamingEngine``): bitwise.
"""
import dataclasses
import runpy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.serve as jserve  # noqa: E402
import repro_torch.serve as pserve  # noqa: E402
from repro.checkpoint import save_tree  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.configs.base import Segment as JaxSegment  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.checkpoint import load_jax_npz, params_from_numpy  # noqa: E402
from repro_torch.configs import get_arch, reduced  # noqa: E402
from repro_torch.configs.base import Segment  # noqa: E402
from repro_torch.launch import serve as port_launch  # noqa: E402
from repro_torch.launch import steps as port_steps  # noqa: E402
from repro_torch.models import Whisper, build_model  # noqa: E402
from repro_torch.models.api import stream_feat_dim  # noqa: E402
from repro_torch.models.api import stream_frame_sync  # noqa: E402
from repro_torch.models.api import supports_streaming  # noqa: E402

REL = 1e-5
K = 5
CPU = dict(device="cpu")
ARCH = "whisper-medium"


class Pair:
    """Reduced whisper in both packages with the same weights;
    ``depth`` decoder layers."""

    def __init__(self, depth: int, seed: int):
        self.jcfg = jax_reduced(jax_get_arch(ARCH))
        self.pcfg = reduced(get_arch(ARCH))
        if depth != 1:
            self.jcfg = self.jcfg.replace(segments=(JaxSegment(
                self.jcfg.segments[0].pattern, depth),))
            self.pcfg = self.pcfg.replace(segments=(Segment(
                self.pcfg.segments[0].pattern, depth),))
        self.jm = jax_build_model(self.jcfg)
        self.jp = self.jm.init(jax.random.key(seed))
        self.pp = params_from_numpy(jax.device_get(self.jp), self.pcfg,
                                    device="cpu")
        self.pm = build_model(self.pcfg, params=self.pp, **CPU)
        self.d = self.pcfg.d_model


_PAIRS = {}


def pair(depth: int = 1) -> Pair:
    """One Pair a depth for the module (JAX init is the slow part)."""
    if depth not in _PAIRS:
        _PAIRS[depth] = Pair(depth, seed=depth)
    return _PAIRS[depth]


def _feats(rng, *shape):
    return (rng.normal(size=shape) * 0.1).astype(np.float32)


def _close(got, ref, what=""):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    err = np.abs(got - ref) / np.maximum(1.0, np.abs(ref))
    assert err.max() <= REL, f"{what}: {err.max():.3e} > {REL}"


def _close_logits(got, ref, what=""):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    scale = np.maximum(1.0, np.abs(ref).max(axis=-1, keepdims=True))
    err = np.abs(got - ref) / scale
    assert err.max() <= REL, f"{what}: {err.max():.3e} > {REL}"


def _bf16_ulp(x):
    a = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(a)) - 7)


def _same_emissions(got, ref):
    """Served (vals, idx): ids equal, values within one bf16 ulp."""
    (gv, gi), (rv, ri) = got, ref
    np.testing.assert_array_equal(gi, ri)
    assert gv.shape == rv.shape
    assert (np.abs(gv - rv) <= _bf16_ulp(np.maximum(np.abs(gv),
                                                    np.abs(rv)))).all()


def _assert_same(a, b):
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[0], b[0])


# ------------------------------------------------------------- registry

@pytest.mark.parametrize("cut", [False, True])
def test_config_matches_reference(cut):
    p, j = get_arch(ARCH), jax_get_arch(ARCH)
    if cut:
        p, j = reduced(p), jax_reduced(j)
    pf = {f.name: getattr(p, f.name) for f in dataclasses.fields(p)}
    for name, val in pf.items():
        ref = getattr(j, name)
        if name == "segments":
            assert [(s.repeat, [dataclasses.astuple(x) for x in s.pattern])
                    for s in val] == \
                [(s.repeat, [dataclasses.astuple(x) for x in s.pattern])
                 for s in ref]
        elif name == "encoder":
            assert val.n_layers == ref.n_layers
        else:
            assert val == ref, name
    assert supports_streaming(p) and not stream_frame_sync(p)
    assert stream_feat_dim(p) == p.d_model


def test_build_refuses_what_is_not_ported():
    cfg = reduced(get_arch(ARCH))
    from repro_torch.models.paging import PagedCacheConfig
    paged = build_model(cfg, paging=PagedCacheConfig(4, 8),
                        generator=torch.Generator().manual_seed(0), **CPU)
    with pytest.raises(ValueError, match="without paging"):
        paged.init_stream_state(1)
    with pytest.raises(ValueError, match="per-row"):
        paged.init_cache(1, 8)
    with pytest.raises(ValueError, match="encoder-decoder"):
        build_model(cfg, decode_kernel=True,
                    generator=torch.Generator().manual_seed(0), **CPU)
    # training (step 10d) is ported: whisper's CE loss and its gradients
    # against the reference's, and apply at explicit positions (a shift
    # of 3 and a negative one: a row that sees no key) as well
    p = pair()
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, p.pcfg.vocab_size, (2, 9)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, 1),
             "enc_embeds": _feats(rng, 2, 12, p.d)}
    jl = jax_steps.make_loss_fn(p.jm, p.jcfg, "ce")
    (jv, _), jg = jax.jit(jax.value_and_grad(jl, has_aux=True))(
        p.jp, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = {n: t.detach().clone().requires_grad_(True)
              for n, t in p.pp.items()}
    pv, met = port_steps.make_loss_fn(p.pm, cfg, "ce")(leaves, batch)
    grads = torch.autograd.grad(pv, list(leaves.values()))
    _close(pv.detach(), float(jv), "whisper ce loss")
    assert float(met["total_loss"]) == float(pv.detach())
    jgp = params_from_numpy(jax.device_get(jg), p.pcfg, device="cpu")
    scale = max(float(np.abs(np.asarray(g)).max()) for g in jgp.values())
    for (n, _), g in zip(leaves.items(), grads):
        _close(g / scale, jgp[n] / scale, f"d loss / d {n}")
    pos = np.arange(9, dtype=np.int32) + 3
    pos[4] = -2
    j_h, _ = p.jm.apply(p.jp, jnp.asarray(tokens),
                        enc_embeds=jnp.asarray(batch["enc_embeds"]),
                        positions=jnp.asarray(pos))
    with torch.no_grad():
        h, _ = p.pm.apply(torch.from_numpy(tokens),
                          enc_embeds=torch.from_numpy(batch["enc_embeds"]),
                          positions=torch.from_numpy(pos))
    _close(h, j_h, "apply at explicit positions")


# ------------------------------------------------------ full-sequence forward

@pytest.mark.parametrize("depth", [1, 2])
def test_encode_apply_and_prefill_match_reference(depth):
    p = pair(depth)
    rng = np.random.default_rng(10 + depth)
    enc = _feats(rng, 2, 12, p.d)
    tokens = rng.integers(0, p.pcfg.vocab_size, (2, 7)).astype(np.int32)
    j_enc = p.jm.encode(p.jp, jnp.asarray(enc))
    j_h, _ = p.jm.apply(p.jp, jnp.asarray(tokens), enc_embeds=jnp.asarray(enc))
    with torch.no_grad():
        _close(p.pm.encode(torch.from_numpy(enc)), j_enc, "encode")
        h, aux = p.pm.apply(torch.from_numpy(tokens),
                            enc_embeds=torch.from_numpy(enc))
    assert aux == {}
    _close(h, j_h, "apply")
    logits = port_steps.make_prefill_step(p.pm, p.pcfg)(
        {"tokens": tokens, "enc_embeds": enc})
    _close_logits(logits, p.jm.unembed(p.jp, j_h[:, -1:]), "prefill logits")


# ----------------------------------------------------------- token decode

@pytest.mark.parametrize("per_row", [False, True])
def test_prefill_cache_and_decode_steps_match_reference(per_row):
    p = pair(2)
    rng = np.random.default_rng(20)
    enc = _feats(rng, 2, 10, p.d)
    toks = rng.integers(0, p.pcfg.vocab_size, (4, 2, 1)).astype(np.int32)
    jc = p.jm.prefill_cache(p.jp, jnp.asarray(enc),
                            p.jm.init_cache(2, 16, jnp.float32,
                                            per_row=per_row))
    pc = p.pm.prefill_cache(torch.from_numpy(enc),
                            p.pm.init_cache(2, 16, torch.float32,
                                            per_row=per_row))
    _close(pc["ck"], jc["ck"], "ck")
    _close(pc["cv"], jc["cv"], "cv")
    step = port_steps.make_serve_step(p.pm, p.pcfg)
    jstep = jax.jit(p.jm.decode_step)
    for t in range(4):
        jl, jc = jstep(p.jp, jc, jnp.asarray(toks[t]))
        nxt, pl, pc = step(pc, torch.from_numpy(toks[t]))
        _close_logits(pl, jl, f"logits at step {t}")
        np.testing.assert_array_equal(
            nxt.numpy()[:, 0], np.argmax(np.asarray(jl)[:, -1], axis=-1))
        for key in ("k", "v"):
            _close(pc[key], jc[key], f"{key} at step {t}")
    np.testing.assert_array_equal(pc["pos"].numpy(), np.asarray(jc["pos"]))
    if per_row:
        rows = np.array([False, True])
        jr = p.jm.reset_cache_rows(jc, jnp.asarray(rows))
        pr = p.pm.reset_cache_rows(pc, torch.from_numpy(rows))
        for key in ("pos", "k", "v", "ck", "cv"):
            _close(pr[key], jr[key], f"reset {key}")


# ------------------------------------------------------------- streaming

def _state_equal(ps, js, what):
    for key in ("pos", "enc_len", "tok"):
        np.testing.assert_array_equal(ps[key].numpy(), np.asarray(js[key]),
                                      err_msg=f"{what}: {key}")
    for key in ("k", "v", "ck", "cv"):
        _close(ps[key], js[key], f"{what}: {key}")


@pytest.mark.parametrize("depth", [1, 2])
def test_stream_step_matches_reference(depth):
    """Three ragged chunks of 4 frames over 3 rows, each chunk with a
    dead row (lens 0), and row 0 running past ``max_frames`` (11 frames
    into 10 slots: the 11th is dropped)."""
    p = pair(depth)
    rng = np.random.default_rng(30 + depth)
    lens = np.array([[4, 2, 0], [3, 0, 4], [4, 4, 1]], np.int32)
    chunks = _feats(rng, 3, 3, 4, p.d)
    js = p.jm.init_stream_state(3, max_frames=10, max_tokens=8)
    ps = p.pm.init_stream_state(3, max_frames=10, max_tokens=8)
    jstep = jax.jit(p.jm.stream_step)
    for c in range(3):
        jh, js = jstep(p.jp, js, jnp.asarray(chunks[c]),
                       lens=jnp.asarray(lens[c]))
        ph, ps = p.pm.stream_step(ps, torch.from_numpy(chunks[c]),
                                  lens=torch.from_numpy(lens[c]))
        _close(ph, jh, f"hidden at chunk {c}")
        _state_equal(ps, js, f"state after chunk {c}")
    np.testing.assert_array_equal(ps["enc_len"].numpy(), [11, 6, 5])
    rows = np.array([True, False, True])
    _state_equal(p.pm.reset_stream_rows(ps, torch.from_numpy(rows)),
                 p.jm.reset_stream_rows(js, jnp.asarray(rows)), "reset")


def test_stream_rows_round_trip_bitwise():
    p = pair()
    rng = np.random.default_rng(40)
    ps = p.pm.init_stream_state(2, max_frames=8, max_tokens=8)
    p.pm.stream_step(ps, torch.from_numpy(_feats(rng, 2, 4, p.d)))
    row = p.pm.pull_stream_row(ps, 1)
    assert all(t.device.type == "cpu" for t in row.values())
    before = {k: v.clone() for k, v in ps.items()}
    p.pm.reset_stream_rows(ps, torch.tensor([False, True]))
    assert int(ps["pos"][1]) == 0 and not ps["ck"][:, 1].any()
    p.pm.put_stream_row(ps, 1, row)
    for key, a in ps.items():
        assert torch.equal(a, before[key]), key


def _utts(rng, lens, d):
    return [_feats(rng, t, d) for t in lens]


def test_stream_server_matches_reference():
    """The reference's lockstep-parity case (lens [11, 4, 19], chunks of
    4, 2 slots, windows of 2): the port's StreamServer against the
    reference's, stream by stream, and the same host-side counts."""
    p = pair()
    utts = _utts(np.random.default_rng(1), [11, 4, 19], p.d)
    kw = dict(n_slots=2, chunk_frames=4, sync_every=2, k=K)
    jsrv = jserve.StreamServer(p.jcfg, p.jp, **kw)
    psrv = pserve.StreamServer(p.pcfg, p.pp, **kw, **CPU)
    jr = [jsrv.submit(u) for u in utts]
    pr = [psrv.submit(u) for u in utts]
    jd, pd = jsrv.drain(), psrv.drain()
    for a, b, u in zip(pr, jr, utts):
        got = pd[a].emissions()
        assert got[0].shape == (-(-u.shape[0] // 4), K)  # one per chunk
        _same_emissions(got, jd[b].emissions())
    for key in ("syncs", "steps", "useful_units", "padded_units"):
        assert psrv.stats[key] == jsrv.stats[key], key


def test_detach_replace_reattach_bitwise():
    p = pair()
    utt_a, utt_b = _utts(np.random.default_rng(2), [40, 12], p.d)
    kw = dict(n_slots=1, chunk_frames=8, sync_every=1, k=K)
    solo = pserve.StreamServer(p.pcfg, p.pp, **kw, **CPU)
    ra = solo.submit(utt_a)
    ref_a = solo.drain()[ra].emissions()
    solo_b = pserve.StreamServer(p.pcfg, p.pp, **kw, **CPU)
    rb = solo_b.submit(utt_b)
    ref_b = solo_b.drain()[rb].emissions()

    srv = pserve.StreamServer(p.pcfg, p.pp, **kw, **CPU)
    ra = srv.submit(utt_a)
    srv.pump()
    srv.pump()
    srv.detach(ra)
    assert srv.n_active == 0
    rb = srv.submit(utt_b)                  # B takes A's (only) slot
    done = {}
    while rb not in done:
        done.update(srv.pump())
    _assert_same(done[rb].emissions(), ref_b)
    srv.reattach(ra)
    _assert_same(srv.drain()[ra].emissions(), ref_a)
    assert srv.stats["parked"] == 1


def test_live_stream_equals_final_submit():
    """A stream fed by ``append`` in whole chunks and then ``close``d
    emits what the same frames submitted at once emit, bitwise."""
    p = pair()
    utt = _utts(np.random.default_rng(3), [24], p.d)[0]
    kw = dict(n_slots=2, chunk_frames=4, sync_every=2, k=K)
    ref = pserve.StreamServer(p.pcfg, p.pp, **kw, **CPU)
    r = ref.submit(utt)
    want = ref.drain()[r].emissions()
    srv = pserve.StreamServer(p.pcfg, p.pp, **kw, **CPU)
    rid = srv.submit(utt[:8], final=False)
    srv.pump()
    srv.append(rid, utt[8:12])
    srv.pump()
    srv.append(rid, utt[12:])
    srv.close(rid)
    _assert_same(srv.drain()[rid].emissions(), want)


def test_max_frames_refusals():
    p = pair()
    srv = pserve.StreamServer(p.pcfg, p.pp, n_slots=1, chunk_frames=4,
                              sync_every=1, max_frames=8, **CPU)
    with pytest.raises(ValueError, match="max_frames"):
        srv.submit(np.zeros((9, p.d), np.float32))
    rid = srv.submit(np.zeros((4, p.d), np.float32), final=False)
    with pytest.raises(ValueError, match="max_frames"):
        srv.append(rid, np.zeros((5, p.d), np.float32))
    srv.append(rid, np.zeros((4, p.d), np.float32))     # exactly 8 fits
    assert srv._state is None or srv._state["ck"].shape[3] == 8


# -------------------------------------------------------- StreamingEngine

def _feed_all(eng, sid, utt, chunk):
    outs = [eng.feed({sid: utt[c0:c0 + chunk]})[sid]
            for c0 in range(0, utt.shape[0], chunk)]
    return (np.concatenate([v for v, _ in outs]),
            np.concatenate([i for _, i in outs]))


def test_engine_single_stream_matches_reference():
    """Where the reference's engine is sound — one stream in a fresh
    engine (its ``_lockstep``) — the port's engine matches it."""
    p = pair()
    utt = _utts(np.random.default_rng(4), [19], p.d)[0]
    jeng = jserve.StreamingEngine(p.jcfg, p.jp, k=K, n_slots=2)
    peng = pserve.StreamingEngine(p.pcfg, p.pp, k=K, n_slots=2, **CPU)
    got = _feed_all(peng, peng.open_stream(), utt, 4)
    _same_emissions(got, _feed_all(jeng, jeng.open_stream(), utt, 4))
    assert got[0].shape == (5, K)


def test_engine_reopened_slot_leaves_other_stream_alone():
    """Slots 0 and 1 fed together, slot 0 closed and opened again for a
    new stream: both streams emit bitwise what each emits alone.  (The
    reference's ``open_stream`` zeroes layer ``sid`` of every stream's
    caches instead of row ``sid``; the port resets the row.)"""
    p = pair()
    u0, u1, u2 = _utts(np.random.default_rng(5), [8, 16, 8], p.d)

    def solo(u):
        eng = pserve.StreamingEngine(p.pcfg, p.pp, k=K, n_slots=2, **CPU)
        return _feed_all(eng, eng.open_stream(), u, 4)

    eng = pserve.StreamingEngine(p.pcfg, p.pp, k=K, n_slots=2, **CPU)
    a, b = eng.open_stream(), eng.open_stream()
    outs = {a: [], b: []}
    for c0 in (0, 4):
        got = eng.feed({a: u0[c0:c0 + 4], b: u1[c0:c0 + 4]})
        outs[a].append(got[a])
        outs[b].append(got[b])
    eng.close_stream(a)
    c = eng.open_stream()
    assert c == a
    outs_c = []
    for c0 in (8, 12):
        got = eng.feed({c: u2[c0 - 8:c0 - 4], b: u1[c0:c0 + 4]})
        outs_c.append(got[c])
        outs[b].append(got[b])

    def cat(xs):
        return (np.concatenate([v for v, _ in xs]),
                np.concatenate([i for _, i in xs]))
    _assert_same(cat(outs[a]), solo(u0))
    _assert_same(cat(outs[b]), solo(u1))
    _assert_same(cat(outs_c), solo(u2))


def test_engine_queued_path_is_the_am_surface():
    p = pair()
    eng = pserve.StreamingEngine(p.pcfg, p.pp, k=K, **CPU)
    with pytest.raises(ValueError, match="acoustic-model"):
        eng.submit(np.zeros((4, p.d), np.float32))


# ------------------------------------------------------ weights, launcher

def test_load_jax_npz_of_a_whisper_checkpoint(tmp_path):
    p = pair()
    path = str(tmp_path / "whisper.npz")
    save_tree(path, p.jp)
    sd = params_from_numpy(load_jax_npz(path), p.pcfg, device="cpu")
    assert sorted(sd) == sorted(p.pm.state_dict())
    for name, t in p.pm.state_dict().items():
        assert torch.equal(sd[name], t), name
    assert sd["dec_blocks.0.cross.wq"].shape == (p.d, p.d)
    meta = Whisper(p.pcfg, device="meta", generator=None)
    assert [n for n, _ in meta.named_parameters()] == list(sd)


def test_launch_serve_whisper_on_the_host(capsys):
    port_launch.main(["--arch", ARCH, "--device", "cpu", "--requests", "2"])
    out = capsys.readouterr().out
    assert "4 streams (2 interactive)" in out
    assert out.count("emissions") == 4


@pytest.mark.parametrize("arch", ["lstm-am", ARCH])
def test_serve_streams_example_on_the_host(arch, capsys):
    """``examples/serve_streams_torch.py`` on the host: tiers, detach and
    reattach, a live stream; every stream finishes with one emission a
    frame (the AM) or a chunk (whisper)."""
    example = runpy.run_path("examples/serve_streams_torch.py",
                             run_name="serve_streams_torch")
    srv, done = example["main"](["--arch", arch, "--device", "cpu"])
    frames = {r: s.feats.shape[0] for r, s in done.items()}
    assert len(done) == 4 and all(s.done for s in done.values())
    for rid, s in done.items():
        v, i = s.emissions()
        want = frames[rid] if arch == "lstm-am" \
            else -(-frames[rid] // srv.chunk)
        assert v.shape == i.shape == (want, 5)
    assert srv.stats["useful_units"] == sum(frames.values())
    assert "detached mid-flight" in capsys.readouterr().out
