"""Port parity: sequence training (sMBR, paper §3.4) and the teacher
stage.

The same inputs go through the reference's ``seqtrain`` and the port's
on the CPU.  The denominator graph is numpy in both and equal bit for
bit.  The port's forward-backward is the scaled recursion (``fb.py``:
O(B * S) kept a step, where the reference's literal step keeps a
(B, S, S) tensor), the same sums in another order: log Z within 1e-5 of
max(1, |log Z|) and gamma within 2e-5 (float32 accumulations of alphas
of magnitude ~40 in another order); the sMBR loss, its gradients and
whole updates within 1e-5, and each gradient and update leaf within 1e-5
of its own largest magnitude (the sMBR gradients are ~1e-4, where a
fixed atol of 1e-5 alone would pass an error of several percent; an
update also gets one float32 ulp of its stored parameter).  Viterbi
paths and the FER's argmax are exact, ties to the first maximum.  The launcher's ``--stage teacher``
runs on the host, resumes inside its sMBR sub-fit without retraining
the CE part, and its checkpoint is the teacher ``--stage targets``
generates with.
"""
import itertools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import LayerSpec as JaxLayerSpec  # noqa: E402
from repro.configs.base import Segment as JaxSegment  # noqa: E402
from repro.configs.lstm_am_7khr import TEACHER as JAX_TEACHER  # noqa: E402
from repro.configs.lstm_am_7khr import CONFIG as JAX_CONFIG  # noqa: E402
from repro.launch.steps import make_loss_fn as jax_make_loss_fn  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.seqtrain import fb as jfb  # noqa: E402
from repro.seqtrain import graphs as jgraphs  # noqa: E402
from repro.seqtrain import smbr as jsmbr  # noqa: E402
from repro import train as jtrain  # noqa: E402
from repro_torch import train  # noqa: E402
from repro_torch.checkpoint import CheckpointStore, params_from_numpy  # noqa: E402
from repro_torch.configs.base import LayerSpec, Segment  # noqa: E402
from repro_torch.configs.lstm_am_7khr import CONFIG, TEACHER  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.seqtrain import fb, graphs, smbr  # noqa: E402

F, H, V = 12, 32, 97
TOL = dict(rtol=1e-5, atol=1e-5)
GAMMA_ATOL = 2e-5
LEAF_REL = 1e-5      # each gradient / update leaf vs its own max


def assert_leaf_close(got, want, rel: float, what: str = ""):
    """max|got - want| <= rel * max|want|: a leaf held relative to its own
    largest magnitude, so a fixed atol cannot hide an error in a leaf of
    small values (an all-zero leaf must match exactly)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, \
        f"{what}: max|diff| {err:.3e} > {rel} x max|want| {scale:.3e}"


def assert_update_close(got, want, before, rel: float, what: str = ""):
    """The update ``got - before`` held to ``want - before`` relative to
    its own largest magnitude, plus one float32 ulp of the parameter
    (the rounding of ``before + update`` into the stored float32)."""
    b = np.asarray(before, np.float64)
    dg, dw = np.asarray(got, np.float64) - b, np.asarray(want, np.float64) - b
    tol = rel * np.abs(dw).max() + np.spacing(
        np.abs(np.asarray(want, np.float32)))
    bad = np.abs(dg - dw) > tol
    assert not bad.any(), \
        f"{what}: {int(bad.sum())} values beyond {rel} x max|update| " \
        f"{np.abs(dw).max():.3e} + 1 ulp (worst {np.abs(dg - dw).max():.3e})"


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _graph_pair(s, seed):
    rng = np.random.default_rng(seed)
    als = [rng.integers(0, s, rng.integers(0, 40)) for _ in range(30)]
    return jgraphs.build_denominator_graph(als, s), \
        graphs.build_denominator_graph(als, s)


def _mask(b, t):
    mask = np.ones((b, t), np.float32)
    mask[1, t - 4:] = 0.0
    mask[-1, t // 3:] = 0.0
    return mask


# ------------------------------------------------------------ graphs

@pytest.mark.parametrize("self_loop,smoothing", [(0.7, 0.1), (0.5, 1.0)])
def test_denominator_graph_bitwise_vs_jax(self_loop, smoothing):
    """A seeded alignment set (empty utterances included): every array
    of the bigram graph bit for bit; the uniform graph too."""
    rng = np.random.default_rng(2)
    als = [rng.integers(0, 23, rng.integers(0, 30)) for _ in range(40)]
    j = jgraphs.build_denominator_graph(als, 23, self_loop=self_loop,
                                        smoothing=smoothing)
    p = graphs.build_denominator_graph(als, 23, self_loop=self_loop,
                                       smoothing=smoothing)
    for a, b in ((j, p), (jgraphs.uniform_graph(23, self_loop=self_loop),
                          graphs.uniform_graph(23, self_loop=self_loop))):
        assert a.n_senones == b.n_senones
        for k in ("log_trans", "log_init", "log_prior"):
            x, y = getattr(a, k), getattr(b, k)
            assert x.dtype == y.dtype == np.float32
            np.testing.assert_array_equal(x.view(np.int32), y.view(np.int32))
    t = p.to("cpu")
    assert t.log_trans.dtype == torch.float32
    np.testing.assert_array_equal(t.log_trans.numpy(), p.log_trans)


# ------------------------------------------------------- forward-backward

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("s", [5, 97])
def test_forward_backward_matches_jax(s, masked):
    """gamma within GAMMA_ATOL and log Z within 1e-5 of max(1, |log Z|),
    ``forward_log_norm`` the same; gamma zero past each row's mask, and
    the literal (B, S, S) twin the same."""
    jg, pg = _graph_pair(s, s)
    rng = np.random.default_rng(s + masked)
    b, t = 3, 17
    lo = rng.normal(size=(b, t, s)).astype(np.float32)
    mask = _mask(b, t) if masked else None
    jargs = (jnp.asarray(lo), jnp.asarray(jg.log_trans),
             jnp.asarray(jg.log_init), None if mask is None
             else jnp.asarray(mask))
    pargs = (_t(lo), _t(pg.log_trans), _t(pg.log_init),
             None if mask is None else _t(mask))
    jgam, jz = jfb.forward_backward(*jargs)
    jz, jn = np.asarray(jz), np.asarray(jfb.forward_log_norm(*jargs))
    zt = dict(rtol=0, atol=1e-5 * max(1.0, float(np.abs(jz).max())))
    for fn in (fb.forward_backward, fb.forward_backward_literal):
        gam, z = fn(*pargs)
        assert gam.shape == (b, t, s) and z.shape == (b,)
        np.testing.assert_allclose(gam.numpy(), np.asarray(jgam), rtol=0,
                                   atol=GAMMA_ATOL)
        np.testing.assert_allclose(z.numpy(), jz, **zt)
        if masked:
            assert float(gam[1, t - 4:].abs().max()) == 0.0
            assert float(gam[-1, t // 3:].abs().max()) == 0.0
            np.testing.assert_allclose(gam[-1, :t // 3].sum(-1).numpy(), 1.0,
                                       atol=1e-4)
    np.testing.assert_allclose(fb.forward_log_norm(*pargs).numpy(), jn, **zt)


def _brute(lo, g):
    """(log Z, gamma) of one (T, S) sequence by enumerating paths."""
    t, s = lo.shape
    paths = list(itertools.product(range(s), repeat=t))
    lps = []
    for path in paths:
        lp = g.log_init[path[0]] + lo[0, path[0]]
        for i in range(1, t):
            lp += g.log_trans[path[i - 1], path[i]] + lo[i, path[i]]
        lps.append(lp)
    logz = np.logaddexp.reduce(np.asarray(lps, np.float64))
    gamma = np.zeros((t, s))
    for path, lp in zip(paths, lps):
        for i, si in enumerate(path):
            gamma[i, si] += np.exp(lp - logz)
    return logz, gamma


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_forward_backward_matches_brute_force(seed):
    """S = 3, T = 4: every path summed in float64 (the reference's own
    check, ``tests/test_seqtrain.py``), within 1e-5."""
    g = graphs.uniform_graph(3, self_loop=0.5) if seed else \
        _graph_pair(3, 9)[1]
    lo = np.random.default_rng(seed).normal(size=(1, 4, 3)).astype(
        np.float32)
    gam, z = fb.forward_backward(_t(lo), _t(g.log_trans), _t(g.log_init))
    logz, gamma = _brute(lo[0], g)
    np.testing.assert_allclose(float(z[0]), logz, rtol=0, atol=1e-5)
    np.testing.assert_allclose(gam[0].numpy(), gamma, rtol=0, atol=1e-5)


def test_forward_backward_keeps_no_s_squared_tensor_a_step():
    """What autograd saves for the sMBR loss's backward grows as
    T * B * S: beside the one (S, S) transition matrix, no more than 48
    float32 values per (t, b, s).  The reference's literal step would
    keep a (B, S, S) tensor each step (S = 400 here: 400x more)."""
    b, t, s = 2, 12, 400
    _, pg = _graph_pair(s, 4)
    rng = np.random.default_rng(4)
    logits = _t(rng.normal(size=(b, t, s)).astype(np.float32))
    logits.requires_grad_(True)
    seen = {}

    def pack(x):
        seen[x.untyped_storage().data_ptr()] = x.untyped_storage().nbytes()
        return x

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        loss, _ = smbr.smbr_loss(logits, _t(rng.integers(0, s, (b, t))),
                                 pg)
    saved = sum(seen.values()) - s * s * 4
    assert saved <= 48 * t * b * s * 4, saved / (t * b * s * 4)
    loss.backward()
    assert torch.isfinite(logits.grad).all()


def test_viterbi_matches_jax_and_pins_the_first_maximum():
    """Random scores: the same best paths.  A graph and scores where
    every path ties: both take state 0 everywhere (the first maximum)."""
    jg, pg = _graph_pair(97, 5)
    lo = np.random.default_rng(5).normal(size=(3, 21, 97)).astype(np.float32)
    want = np.asarray(jfb.viterbi(jnp.asarray(lo), jnp.asarray(jg.log_trans),
                                  jnp.asarray(jg.log_init)))
    got = fb.viterbi(_t(lo), _t(pg.log_trans), _t(pg.log_init))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    tie = graphs.uniform_graph(4, self_loop=0.25)
    flat = np.zeros((2, 6, 4), np.float32)
    jt = jgraphs.uniform_graph(4, self_loop=0.25)
    want = np.asarray(jfb.viterbi(jnp.asarray(flat), jnp.asarray(jt.log_trans),
                                  jnp.asarray(jt.log_init)))
    got = fb.viterbi(_t(flat), _t(tie.log_trans), _t(tie.log_init))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got.numpy().any()


# ------------------------------------------------------------------ sMBR

@pytest.mark.parametrize("masked", [False, True])
def test_smbr_loss_and_logit_gradient_match_jax(masked):
    jg, pg = _graph_pair(V, 6)
    rng = np.random.default_rng(6 + masked)
    b, t = 3, 15
    logits = (rng.normal(size=(b, t, V)) * 2).astype(np.float32)
    labels = rng.integers(0, V, (b, t)).astype(np.int32)
    mask = _mask(b, t) if masked else None

    def jloss(x):
        return jsmbr.smbr_loss(x, jnp.asarray(labels), jg, kappa=0.3,
                               mask=None if mask is None
                               else jnp.asarray(mask))

    (jl, jm), jgr = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(logits))
    x = _t(logits).requires_grad_(True)
    pl, pm = smbr.smbr_loss(x, _t(labels), pg, kappa=0.3,
                            mask=None if mask is None else _t(mask))
    pl.backward()
    assert -1.0 <= float(pl.detach()) <= 0.0
    np.testing.assert_allclose(float(pl.detach()), float(jl), **TOL)
    np.testing.assert_allclose(float(pm["expected_frame_acc"]),
                               float(jm["expected_frame_acc"]), **TOL)
    np.testing.assert_allclose(float(pm["log_z"]), float(jm["log_z"]),
                               rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgr), **TOL)
    assert_leaf_close(x.grad.numpy(), np.asarray(jgr), LEAF_REL, "d/dlogits")


def _cfg(base, seg_cls, spec_cls, mixer):
    return base.replace(
        lstm_hidden=H, feat_dim=F, n_senones=V, vocab_size=V,
        segments=(seg_cls((spec_cls(mixer=mixer, ffn="none"),), repeat=2),))


def _flat(tree) -> dict:
    return {".".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _models(mixer, seed):
    """(jax cfg, model, params, port cfg, model, params): one set of
    weights carried through ``params_from_numpy``."""
    jbase, pbase = (JAX_TEACHER, TEACHER) if mixer == "bilstm" \
        else (JAX_CONFIG, CONFIG)
    jcfg = _cfg(jbase, JaxSegment, JaxLayerSpec, mixer)
    pcfg = _cfg(pbase, Segment, LayerSpec, mixer)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.key(seed))
    pp = params_from_numpy(jax.device_get(jp), pcfg, device="cpu")
    return jcfg, jm, jp, pcfg, build_model(pcfg, device="cpu", params=pp), pp


def _seq_batch(seed, b=3, t=11):
    rng = np.random.default_rng(seed)
    mask = _mask(b, t)
    return {"feats": (rng.normal(size=(b, t, F)) * mask[..., None])
            .astype(np.float32),
            "labels": rng.integers(0, V, (b, t)).astype(np.int32),
            "mask": mask}


@pytest.mark.parametrize("ce_smooth", [0.0, 0.3])
def test_make_smbr_loss_fn_matches_jax(ce_smooth):
    """The loss over the student: value, metrics and every parameter's
    gradient within 1e-5."""
    jcfg, jm, jp, pcfg, pm, pp = _models("lstm", 1)
    jg, pg = _graph_pair(V, 7)
    batch = _seq_batch(8)
    jfn = jsmbr.make_smbr_loss_fn(jm, jcfg, jg, kappa=0.3,
                                  ce_smooth=ce_smooth)
    (jl, jmet), jgr = jax.value_and_grad(jfn, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    pfn = smbr.make_smbr_loss_fn(pm, pcfg, pg, kappa=0.3, ce_smooth=ce_smooth)
    loss, met, grads = train.strategies.loss_and_grads(pfn, pp, batch)
    np.testing.assert_allclose(float(loss), float(jl), **TOL)
    assert set(met) == set(jmet)
    for k in met:
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-5,
                                   atol=1e-5)
    jflat = _flat(jgr)
    assert sorted(grads) == sorted(jflat)
    for n, a in jflat.items():
        np.testing.assert_allclose(grads[n].numpy(), a, **TOL)
        assert_leaf_close(grads[n].numpy(), a, LEAF_REL, n)


def test_frame_error_rate_matches_jax_with_ties():
    """Argmax ties go to the first maximum in both (row 1's logits all
    equal: predicted 0)."""
    logits = np.array([[[0.0, 5.0, 5.0], [1.0, 1.0, 1.0], [5.0, 0.0, 0.0]]],
                      np.float32)
    labels = np.array([[1, 0, 1]], np.int32)
    mask = np.array([[1.0, 1.0, 0.0]], np.float32)
    for m in (None, mask):
        want = float(jsmbr.frame_error_rate(
            jnp.asarray(logits), jnp.asarray(labels),
            None if m is None else jnp.asarray(m)))
        got = float(smbr.frame_error_rate(_t(logits), labels, m))
        assert got == want
    assert float(smbr.frame_error_rate(_t(logits), labels, mask)) == 0.0


# ------------------------------------------------------- teacher updates

@pytest.mark.parametrize("kind", ["ce", "smbr"])
def test_one_teacher_update_matches_jax(kind):
    """The biLSTM teacher's first backward: one CE update under
    ``Local()`` and one sMBR update under ``Local(clip=0.0)`` through
    both Trainers from one set of weights: loss, metrics and every
    parameter within 1e-5."""
    jcfg, jm, jp, pcfg, pm, pp = _models("bilstm", 2)
    batch = _seq_batch(9, b=4, t=13)
    if kind == "ce":
        jfn, pfn = (jax_make_loss_fn(jm, jcfg, "ce"),
                    steps.make_loss_fn(pm, pcfg, "ce"))
        js, ps, lr = jtrain.Local(), train.Local(), 0.05
    else:
        jg, pg = _graph_pair(V, 10)
        jfn = jsmbr.make_smbr_loss_fn(jm, jcfg, jg, kappa=0.3)
        pfn = smbr.make_smbr_loss_fn(pm, pcfg, pg, kappa=0.3)
        js, ps, lr = jtrain.Local(clip=0.0), train.Local(clip=0.0), 5.0
    jsink, psink = jtrain.ListSink(), train.ListSink()
    jtr = jtrain.Trainer(js, {kind: jfn}, metrics=jsink)
    ptr = train.Trainer(ps, {kind: pfn}, metrics=psink)
    jst = jtr.fit(jtr.init_state(jp), [jtrain.TrainBatch(batch, lr, kind)])
    pst = ptr.fit(ptr.init_state(pp), [train.TrainBatch(batch, lr, kind)])
    assert pst.step == int(jst.step) == 1
    (_, jrec), = [(s, m) for s, _, m in jsink.records]
    (_, prec), = [(s, m) for s, _, m in psink.records]
    assert set(prec) <= set(jrec)            # the reference adds moe_lb
    for k in prec:
        np.testing.assert_allclose(prec[k], jrec[k], rtol=1e-5, atol=1e-5)
    jflat = _flat(jst.params)
    assert list(pst.params) == list(jflat)
    moved, j0 = 0, _flat(jp)
    for n, a in jflat.items():
        np.testing.assert_allclose(pst.params[n].numpy(), a, **TOL)
        assert_update_close(pst.params[n].numpy(), a, j0[n], LEAF_REL, n)
        moved += not np.array_equal(a, j0[n])
    assert moved == len(jflat)


# ------------------------------------------------------------ the launcher

def test_launch_teacher_on_the_host_and_targets_use_it(tmp_path, capsys):
    """--stage teacher: the reference's keys, the trained teacher in
    ckpt_teacher; --stage targets then generates with it (and reports
    so), where a fresh --out gets a random-init teacher written."""
    res = launch_train.main(["--stage", "teacher", "--device", "cpu",
                             "--out", str(tmp_path)])
    assert np.isfinite(res["loss_last"]) and 0 <= res["val_fer"] <= 1
    assert 0 < res["smbr_eacc"] <= 1 and np.isfinite(res["smbr_log_z"])
    assert res["ce_updates"] == res["ce_updates_run"] == 18
    assert res["smbr_updates"] == res["smbr_updates_run"] == 4
    assert res["ce_frames"] > 0 and res["smbr_frames"] > 0
    assert json.loads((tmp_path / "train_teacher.json").read_text()) == res
    store = CheckpointStore(str(tmp_path / "ckpt_teacher"))
    assert store.steps() == [0]
    assert store.load_meta(0)["teacher"] == "trained (--stage teacher)"
    for stage in ("teacher", "teacher_smbr"):
        assert CheckpointStore(str(tmp_path / f"ckpt_{stage}" / "state")
                               ).steps() == []
    printed = capsys.readouterr().out
    assert "sMBR updates" in printed
    assert json.loads(printed.strip().splitlines()[-1][len("[train] "):]) \
        == {k: res[k] for k in ("loss_last", "val_fer", "smbr_eacc")}
    trained = dict(np.load(store.path(0)))
    rep = launch_train.main(["--stage", "targets", "--device", "cpu",
                             "--out", str(tmp_path)])
    assert rep["teacher_ckpt"] == "trained (--stage teacher)"
    for k, v in np.load(store.path(0)).items():
        np.testing.assert_array_equal(v, trained[k])
    fresh = launch_train.main(["--stage", "targets", "--device", "cpu",
                               "--out", str(tmp_path / "fresh")])
    assert fresh["teacher_ckpt"] == "random init, seed 1"


def _killed_after(n_items, real):
    def source(*args, **kwargs):
        for i, tb in enumerate(real(*args, **kwargs)):
            if i == n_items:
                raise RuntimeError("killed")
            yield tb
    return source


def test_teacher_killed_in_smbr_resumes_without_retraining_ce(
        tmp_path, monkeypatch):
    """The teacher stage checkpointing every update, killed after 2 of
    its 4 sMBR updates: the re-invocation runs no CE update, resumes the
    sMBR sub-fit at update 2, and ends bitwise where an uninterrupted
    stage does."""
    kw = dict(full=False, device="cpu", ckpt_every=1, log=lambda _m: None)
    whole = launch_train.stage_teacher(out=str(tmp_path / "whole"), **kw)
    real = launch_train.smbr_source
    monkeypatch.setattr(launch_train, "smbr_source", _killed_after(2, real))
    with pytest.raises(RuntimeError, match="killed"):
        launch_train.stage_teacher(out=str(tmp_path / "killed"), **kw)
    monkeypatch.setattr(launch_train, "smbr_source", real)
    resumed = launch_train.stage_teacher(out=str(tmp_path / "killed"), **kw)
    r = resumed.results
    assert (r["ce_resumed_at"], r["ce_updates_run"]) == (18, 0)
    assert (r["smbr_resumed_at"], r["smbr_updates_run"]) == (2, 2)
    assert r["loss_last"] is None and r["smbr_eacc"] is not None
    for n, x in whole.state.params.items():
        assert torch.equal(x, resumed.state.params[n]), n
    assert r["val_fer"] == whole.results["val_fer"]
