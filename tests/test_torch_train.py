"""Port parity: the student stage's training path.

The same weights, batches and teacher targets go through the JAX
reference and the port on the CPU: the losses (``core/distill.py``), the
optimizer and schedules, the scheduled-learning phase stream, the v1
logit store (each package reads the other's shards), the teacher's
target generation, and whole ``Trainer.fit`` updates under ``Local`` and
``GTC``.  The v2 store and sharded generation are
``test_torch_store.py`` and ``test_torch_generate.py``.  Losses, gradients and parameters agree within 1e-5 (float32,
different sum orders); GTC is discontinuous at |acc| == tau, so the
update tests assert that no |acc| lies within 1e-6 of tau instead of
loosening the bar.  The launcher runs end to end on the host.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import LayerSpec as JaxLayerSpec  # noqa: E402
from repro.configs.base import Segment as JaxSegment  # noqa: E402
from repro.configs.lstm_am_7khr import CONFIG as JAX_CONFIG  # noqa: E402
from repro.configs.lstm_am_7khr import TEACHER as JAX_TEACHER  # noqa: E402
from repro.core import distill as jdistill  # noqa: E402
from repro.core import logit_store as jls  # noqa: E402
from repro.core import scheduled as jsched  # noqa: E402
from repro.core.teacher import TeacherRunner as JaxTeacherRunner  # noqa: E402
from repro.distributed.gtc import GTCConfig as JaxGTCConfig  # noqa: E402
from repro.launch.steps import make_loss_fn as jax_make_loss_fn  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.optim import schedules as jschedules  # noqa: E402
from repro import train as jtrain  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch import train  # noqa: E402
from repro_torch.checkpoint import params_from_numpy  # noqa: E402
from repro_torch.configs.base import LayerSpec, Segment  # noqa: E402
from repro_torch.configs.lstm_am_7khr import CONFIG, TEACHER  # noqa: E402
from repro_torch.core import distill, logit_store, scheduled  # noqa: E402
from repro_torch.core.teacher import TeacherRunner, make_teacher_config  # noqa: E402
from repro_torch.distributed import gtc  # noqa: E402
from repro_torch.distributed.bmuf import BMUFConfig  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import schedules  # noqa: E402
from repro_torch.utils.trees import leaf_order  # noqa: E402

F, H, V, K = 12, 32, 97, 20
B, S = 4, 8
# The update tests' GTC threshold.  At the stage's 2e-4 some of the
# model's 17k |acc| values fall within 1e-9 of tau on these inputs, where
# a last-bit difference flips a send; at 1e-2 the nearest is 2.5e-6 away
# and 14-107 values are still sent per update.  The bitwise test of the
# compression pipeline (tests/test_torch_gtc.py) runs at 2e-4.
TAU = 1e-2
TOL = dict(rtol=1e-5, atol=1e-5)
GAP = 1e-4


def _cfg(base, seg_cls, spec_cls, mixer):
    return base.replace(
        lstm_hidden=H, feat_dim=F, n_senones=V, vocab_size=V,
        segments=(seg_cls((spec_cls(mixer=mixer, ffn="none"),), repeat=2),))


def _flat(tree) -> dict:
    """A JAX param tree -> {dotted name: numpy array}."""
    return {".".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def student():
    """(jax cfg, jax model, jax params, port cfg, port model, port params)
    with one set of weights."""
    jcfg = _cfg(JAX_CONFIG, JaxSegment, JaxLayerSpec, "lstm")
    pcfg = _cfg(CONFIG, Segment, LayerSpec, "lstm")
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.key(3))
    pp = params_from_numpy(jax.device_get(jp), pcfg, device="cpu")
    return jcfg, jm, jp, pcfg, build_model(pcfg, device="cpu", params=pp), pp


def _distill_batch(seed):
    rng = np.random.default_rng(seed)
    vals = -np.sort(-rng.normal(size=(B, S, K)) * 3, axis=-1)
    idx = np.stack([rng.permutation(V)[:K] for _ in range(B * S)])
    mask = np.ones((B, S), np.float32)
    mask[-1, S // 2:] = 0.0
    return {"feats": rng.normal(size=(B, S, F)).astype(np.float32),
            "mask": mask,
            "topk_vals": (vals - vals[..., :1]).astype(np.float32),
            "topk_idx": idx.reshape(B, S, K).astype(np.int32)}


def _ce_batch(seed):
    rng = np.random.default_rng(seed)
    return {"feats": rng.normal(size=(B, S, F)).astype(np.float32),
            "labels": rng.integers(0, V, (B, S)).astype(np.int32),
            "mask": np.ones((B, S), np.float32)}


# ------------------------------------------------------------------ losses

def test_soft_ce_and_topk_soft_ce_match_jax():
    rng = np.random.default_rng(0)
    s = rng.normal(size=(3, 5, V)).astype(np.float32)
    t = rng.normal(size=(3, 5, V)).astype(np.float32)
    b = _distill_batch(1)
    vals, idx = b["topk_vals"][:3, :5], b["topk_idx"][:3, :5]
    np.testing.assert_allclose(
        float(distill.soft_ce(_t(s), _t(t), temperature=2.0)),
        float(jdistill.soft_ce(jnp.asarray(s), jnp.asarray(t), 2.0)), **TOL)
    jv, jg = jax.value_and_grad(lambda x: jdistill.topk_soft_ce(
        x, jnp.asarray(vals), jnp.asarray(idx)))(jnp.asarray(s))
    ps = _t(s).requires_grad_(True)
    pv = distill.topk_soft_ce(ps, _t(vals), _t(idx))
    pv.backward()
    np.testing.assert_allclose(pv.item(), float(jv), **TOL)
    np.testing.assert_allclose(ps.grad.numpy(), np.asarray(jg), **TOL)


@pytest.mark.parametrize("kind,chunk,cap,masked", [
    ("distill", 8192, 0.0, True), ("distill", 32, 0.0, False),
    ("distill", 40, 30.0, True), ("ce", 8192, 0.0, True),
    ("ce", 32, 30.0, False)])
def test_chunked_losses_match_jax(kind, chunk, cap, masked):
    """Value and (dh, dw) of the streamed chunk loop -- the host path --
    against the reference's, one chunk or several (the last ragged)."""
    rng = np.random.default_rng(chunk + int(cap))
    h = rng.normal(size=(B, S, H)).astype(np.float32)
    w = (rng.normal(size=(H, V)) / np.sqrt(H)).astype(np.float32)
    b = _distill_batch(2) if kind == "distill" else _ce_batch(2)
    mask = b["mask"] if masked else None

    def jloss(hh, ww):
        m = None if mask is None else jnp.asarray(mask)
        if kind == "distill":
            return jdistill.chunked_topk_distill_ce(
                hh, ww, jnp.asarray(b["topk_vals"]),
                jnp.asarray(b["topk_idx"]), chunk=chunk, softcap=cap, mask=m)
        return jdistill.chunked_ce(hh, ww, jnp.asarray(b["labels"]),
                                   chunk=chunk, softcap=cap, mask=m)

    jl, (jdh, jdw) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w))
    ph, pw = _t(h).requires_grad_(True), _t(w).requires_grad_(True)
    m = None if mask is None else _t(mask)
    if kind == "distill":
        pl = distill.chunked_topk_distill_ce(
            ph, pw, _t(b["topk_vals"]), _t(b["topk_idx"]), chunk=chunk,
            softcap=cap, mask=m)
    else:
        pl = distill.chunked_ce(ph, pw, _t(b["labels"]).long(), chunk=chunk,
                                softcap=cap, mask=m)
    pl.backward()
    np.testing.assert_allclose(pl.item(), float(jl), **TOL)
    np.testing.assert_allclose(ph.grad.numpy(), np.asarray(jdh), **TOL)
    np.testing.assert_allclose(pw.grad.numpy(), np.asarray(jdw), **TOL)


def test_chunked_distill_kernel_route_follows_the_device():
    h = torch.zeros((1, 2, 4))
    w = torch.zeros((4, 9))
    vals = torch.zeros((1, 2, 3))
    idx = torch.zeros((1, 2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        distill.chunked_topk_distill_ce(h, w, vals, idx, use_kernel=True)
    assert torch.isfinite(distill.chunked_topk_distill_ce(h, w, vals, idx))


# ---------------------------------------------------- optimizer, schedules

def _grads(seed, shapes):
    rng = np.random.default_rng(seed)
    return {n: rng.normal(size=s).astype(np.float32) * 0.3
            for n, s in shapes.items()}


def _nested(flat):
    out = {}
    for n, a in flat.items():
        node = out
        *path, leaf = n.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(a)
    return out


SHAPES = {"l0.wx": (5, 8), "l0.wh": (2, 8), "l0.b": (8,), "l1.wx": (2, 8),
          "out": (2, 3)}


@pytest.mark.parametrize("max_norm", [1.0, 100.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    g = _grads(0, SHAPES)
    jg, jn = joptim.clip_by_global_norm(_nested(g), max_norm)
    pg, pn = optim.clip_by_global_norm({n: _t(a) for n, a in g.items()},
                                       max_norm)
    assert list(pg) == leaf_order(g)
    np.testing.assert_allclose(pn.item(), float(jn), rtol=1e-6)
    for n, a in _flat(jg).items():
        np.testing.assert_allclose(pg[n].numpy(), a, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("opt,nesterov", [("momentum", True),
                                          ("momentum", False),
                                          ("adam", None)])
def test_optimizer_updates_match_jax(opt, nesterov):
    """Three updates from zeros state; momentum is bitwise (elementwise
    arithmetic in the same order), Adam within float32 rounding."""
    params = _grads(1, SHAPES)
    jp, pp = _nested(params), {n: _t(a) for n, a in params.items()}
    if opt == "momentum":
        js, ps = joptim.momentum_init(jp), optim.momentum_init(pp)
    else:
        js, ps = joptim.adam_init(jp), optim.adam_init(pp)
    for i in range(3):
        g = _grads(10 + i, SHAPES)
        if opt == "momentum":
            jp, js = joptim.momentum_update(jp, _nested(g), js, lr=0.05,
                                            nesterov=nesterov)
            pp, ps = optim.momentum_update(pp, {n: _t(a) for n, a in
                                                g.items()}, ps, lr=0.05,
                                           nesterov=nesterov)
        else:
            jp, js = joptim.adam_update(jp, _nested(g), js, lr=1e-3)
            pp, ps = optim.adam_update(pp, {n: _t(a) for n, a in g.items()},
                                       ps, lr=1e-3)
    for n, a in _flat(jp).items():
        if opt == "momentum":
            np.testing.assert_array_equal(pp[n].numpy(), a)
        else:
            np.testing.assert_allclose(pp[n].numpy(), a, rtol=1e-6,
                                       atol=1e-7)


def test_schedules_match_jax():
    pairs = [(schedules.exponential_decay(0.1, 0.85, 3),
              jschedules.exponential_decay(0.1, 0.85, 3)),
             (schedules.warmup_exponential(0.1, 4, 0.9, 5),
              jschedules.warmup_exponential(0.1, 4, 0.9, 5)),
             (schedules.warmup_hold_decay(0.1, 3, 4, 0.8, 2, floor=0.02),
              jschedules.warmup_hold_decay(0.1, 3, 4, 0.8, 2, floor=0.02))]
    for p, j in pairs:
        assert isinstance(p, schedules.Schedule)
        assert p.desc == j.desc
        for step in range(0, 40, 3):
            assert p(step) == pytest.approx(j(step), rel=1e-6)


@pytest.mark.parametrize("cfg", ["paper_100k", "paper_1m", "launch"])
def test_scheduled_phases_match_jax(cfg):
    if cfg == "launch":
        pc = launch_train.SCHEDULE
        jc = jsched.ScheduleConfig(**vars(pc))
    else:
        pc = getattr(scheduled.ScheduleConfig, cfg)(lr0=1e-3)
        jc = getattr(jsched.ScheduleConfig, cfg)(lr0=1e-3)
    assert [vars(p) for p in scheduled.phases(pc)] == \
        [vars(p) for p in jsched.phases(jc)]
    assert scheduled.describe(pc) == jsched.describe(jc)


def test_scheduled_source_matches_jax():
    """The launcher's schedule through both packages' scheduled_source:
    the same (loss, lr) stream, phase for phase."""
    def stream(src_mod, tb_cls, cfg):
        def unl(ph):
            return (tb_cls({"i": i}, ph.lr, "distill_topk") for i in range(2))

        def lab(ph):
            return (tb_cls({"o": ph.feature_offset}, ph.lr, "ce")
                    for _ in range(3))
        return [(tb.loss, tb.lr, tb.data) for tb in
                src_mod.scheduled_source(cfg, unlabeled=unl, labeled=lab)]

    pc = launch_train.SCHEDULE
    ours = stream(train, train.TrainBatch, pc)
    theirs = stream(jtrain, jtrain.TrainBatch,
                    jsched.ScheduleConfig(**vars(pc)))
    assert ours == theirs and len(ours) == 10


def test_epoch_source_chain_and_sinks(tmp_path):
    src = train.chain(
        train.epoch_source(lambda ep: [{"ep": ep}] * 2, 2, lambda ep: ep,
                           "ce"),
        train.epoch_source(lambda ep: [{}], 1,
                           schedules.exponential_decay(1.0, 0.5, 1)))
    items = list(src)
    assert [tb.lr for tb in items[:4]] == [0, 0, 1, 1]
    assert isinstance(items[4].lr, schedules.Schedule)
    lst = train.ListSink()
    jl = train.JsonlSink(str(tmp_path / "m.jsonl"))
    tee = train.TeeSink(lst, jl)
    tee.emit(1, "ce", {"loss": 2.0})
    tee.emit(2, "distill_topk", {"loss": 1.0})
    assert lst.values("loss") == [2.0, 1.0] and lst.first("loss", "ce") == 2.0
    assert lst.last("loss") == 1.0 and len(lst) == 2
    lines = (tmp_path / "m.jsonl").read_text().splitlines()
    assert json.loads(lines[1]) == {"step": 2, "tag": "distill_topk",
                                    "loss": 1.0}


# ------------------------------------------------------------ whole updates

def _acc_margin(monkeypatch):
    """Record min | |residual + grad| - tau | over every compressed leaf."""
    seen = []
    real = gtc.compress_leaf

    def spy(g, r, tau, *, use_kernel=None):
        acc = r.float() + g.float()
        seen.append(float(((acc.abs() - tau).abs()).min()))
        return real(g, r, tau, use_kernel=use_kernel)

    monkeypatch.setattr(gtc, "compress_leaf", spy)
    return seen


@pytest.mark.parametrize("strategy", ["local", "gtc"])
def test_three_updates_match_jax(student, strategy, monkeypatch):
    """Distill, CE, distill updates through both Trainers from one
    shared checkpoint: per-update losses and the final params (and GTC
    residuals) within 1e-5."""
    jcfg, jm, jp, pcfg, pm, pp = student
    batches = [("distill_topk", _distill_batch(20), 0.05),
               ("ce", _ce_batch(21), 0.075),
               ("distill_topk", _distill_batch(22), 0.0425)]
    if strategy == "gtc":
        js, ps = (jtrain.GTC(JaxGTCConfig(tau=TAU, n_workers=1)),
                  train.GTC(gtc.GTCConfig(tau=TAU, n_workers=1)))
    else:
        js, ps = jtrain.Local(), train.Local()
    margins = _acc_margin(monkeypatch)
    jsink, psink = jtrain.ListSink(), train.ListSink()
    jtr = jtrain.Trainer(js, {k: jax_make_loss_fn(jm, jcfg, k)
                              for k in ("distill_topk", "ce")},
                         metrics=jsink)
    ptr = train.Trainer(ps, {k: steps.make_loss_fn(pm, pcfg, k)
                             for k in ("distill_topk", "ce")},
                        metrics=psink)
    jstate = jtr.fit(jtr.init_state(jp), [jtrain.TrainBatch(b, lr, k)
                                          for k, b, lr in batches])
    pstate = ptr.fit(ptr.init_state(pp), [train.TrainBatch(b, lr, k)
                                          for k, b, lr in batches])
    assert pstate.step == int(jstate.step) == 3
    np.testing.assert_allclose(psink.values("loss"), jsink.values("loss"),
                               **TOL)
    np.testing.assert_allclose(psink.values("grad_norm"),
                               jsink.values("grad_norm"), **TOL)
    jflat = _flat(jstate.params)
    assert list(pstate.params) == list(jflat)
    for n, a in jflat.items():
        np.testing.assert_allclose(pstate.params[n].numpy(), a, **TOL)
    if strategy == "gtc":
        assert len(margins) == 3 * len(jflat)
        assert min(margins) > 1e-6, min(margins)
        dens = psink.values("gtc_density")
        np.testing.assert_allclose(dens, jsink.values("gtc_density"),
                                   rtol=1e-6)
        assert all(0 < d < 1 for d in dens)
        for n, a in _flat(jstate.strategy_state["residual"]).items():
            np.testing.assert_allclose(
                pstate.strategy_state["residual"][n].numpy(), a, **TOL)


def test_make_train_step_matches_trainer(student):
    _, _, _, pcfg, pm, pp = student
    b = _distill_batch(30)
    step = steps.make_train_step(pm, pcfg, loss_kind="distill_topk")
    p1, _, m1 = step(pp, train.init_opt(pp), b, 0.05)
    tr = train.Trainer(train.Local(), {"distill_topk": steps.make_loss_fn(
        pm, pcfg, "distill_topk")})
    st = tr.fit(tr.init_state(pp), [train.TrainBatch(b, 0.05,
                                                     "distill_topk")])
    for n in p1:
        assert torch.equal(p1[n], st.params[n])
    assert set(m1) == {"loss", "total_loss", "grad_norm"}


def test_unported_paths_raise(student):
    _, _, _, pcfg, pm, pp = student
    fn = steps.make_loss_fn(pm, pcfg, "ce")
    tr = train.Trainer(train.Local(), fn)
    with pytest.raises(NotImplementedError, match="not ported.*step 8"):
        tr.fit(tr.init_state(pp), [], membership=object())
    with pytest.raises(NotImplementedError, match="not ported"):
        train.BMUFShardMap()
    shard = train.GTCShardMap(gtc.GTCConfig(n_workers=2))
    with pytest.raises(NotImplementedError, match="not ported.*step 8"):
        train.GTCShardMap(gtc.GTCConfig(n_workers=2), mesh=object())
    bmuf = train.BMUFVmap(BMUFConfig(n_workers=2, block_steps=1))
    for strat in (bmuf, shard):
        with pytest.raises(NotImplementedError, match="not ported.*step 8"):
            strat.resize(tr.init_state(pp), 1)
    with pytest.raises(NotImplementedError, match="not ported.*step 8"):
        tr.resize(tr.init_state(pp), 2)
    with pytest.raises(ValueError, match="single-process"):
        train.GTC(gtc.GTCConfig(n_workers=2))
    with pytest.raises(NotImplementedError, match="not ported"):
        steps.make_loss_fn(pm, pcfg.replace(family="dense"), "ce")
    with pytest.raises(KeyError, match="loss kind"):
        tr.fit(tr.init_state(pp), [train.TrainBatch(_ce_batch(0), 0.1,
                                                    "smbr")])


# ----------------------------------------------------- targets and store

def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.filterwarnings("ignore:overflow encountered in cast")
def test_v1_store_cross_read(tmp_path):
    """Each package reads the other's shards: the same bf16 values (after
    the bf16 -> f16 -> bf16 double rounding) and the same ids."""
    rng = np.random.default_rng(4)
    vals = _bf16(rng.normal(size=(2, 6, K)) * 4).copy()
    vals[0, 0, :3] = [0.0, -1e-6, -70000.0]     # f16 underflow / overflow
    idx = rng.integers(0, V, (2, 6, K)).astype(np.int32)
    jstore = jls.LogitStore(str(tmp_path / "j"), k=K, vocab=V)
    pstore = logit_store.LogitStore(str(tmp_path / "p"), k=K, vocab=V)
    jstore.write_shard(0, jnp.asarray(vals, jnp.bfloat16), jnp.asarray(idx))
    pstore.write_shard(0, torch.from_numpy(vals).to(torch.bfloat16),
                       torch.from_numpy(idx))
    for root in ("j", "p"):
        jv, ji = jls.LogitStore(str(tmp_path / root)).read_shard(0)
        pv, pi = logit_store.LogitStore(str(tmp_path / root)).read_shard(0)
        assert pv.dtype == torch.bfloat16 and pi.dtype == torch.int32
        np.testing.assert_array_equal(pv.float().numpy(),
                                      np.asarray(jv.astype(jnp.float32)))
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    for name in ("shard_00000.npz", "meta.json"):
        assert (tmp_path / "j" / name).exists()
        assert (tmp_path / "p" / name).exists()
    assert pstore.shards() == jstore.shards()
    assert pstore.stats() == logit_store.ShardMeta(12, K, V)


def test_reconstruct_matches_jax():
    b = _distill_batch(5)
    vals, idx = b["topk_vals"], b["topk_idx"]
    jr = np.asarray(jls.reconstruct(jnp.asarray(vals), jnp.asarray(idx), V))
    np.testing.assert_array_equal(
        logit_store.reconstruct(_t(vals), _t(idx), V).numpy(), jr)
    blocks = list(logit_store.iter_reconstruct(_t(vals), _t(idx), V,
                                               row_chunk=7))
    assert [(lo, hi) for lo, hi, _ in blocks] == \
        [(lo, hi) for lo, hi, _ in jls.iter_reconstruct(vals, idx, V, 7)]
    np.testing.assert_array_equal(np.concatenate([bl for *_, bl in blocks]),
                                  jr.reshape(-1, V))


def test_teacher_generate_to_store_matches_jax(tmp_path):
    """The teacher's targets through each package's store: ids equal
    where the logits separate them by more than 1e-4, values within one
    bf16 ulp."""
    jcfg = _cfg(JAX_TEACHER, JaxSegment, JaxLayerSpec, "bilstm")
    pcfg = _cfg(TEACHER, Segment, LayerSpec, "bilstm")
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.key(7))
    pp = params_from_numpy(jax.device_get(jp), pcfg, device="cpu")
    rng = np.random.default_rng(8)
    batches = []
    for _ in range(2):
        mask = np.ones((B, S), np.float32)
        mask[1, 5:] = 0.0
        batches.append({"feats": rng.normal(size=(B, S, F))
                        .astype(np.float32), "mask": mask})
    jstore = jls.LogitStore(str(tmp_path / "j"), k=K, vocab=V)
    pstore = logit_store.LogitStore(str(tmp_path / "p"), k=K, vocab=V)
    JaxTeacherRunner(jcfg, jp, k=K).generate_to_store(jstore, batches)
    runner = TeacherRunner(pcfg, pp, k=K, device="cpu")
    runner.generate_to_store(pstore, batches)
    for i, b in enumerate(batches):
        lens = jnp.asarray(b["mask"].sum(-1).astype(np.int32))
        h, _ = jm.apply(jp, jnp.asarray(b["feats"]), lens=lens)
        logits = np.asarray(jm.unembed(jp, h)).reshape(-1, V)
        jv, ji = jstore.read_shard(i)
        pv, pi = pstore.read_shard(i)
        jv = np.asarray(jv.astype(jnp.float32)).reshape(-1, K)
        ji = np.asarray(ji).reshape(-1, K)
        pv, pi = pv.float().numpy().reshape(-1, K), pi.numpy().reshape(-1, K)
        top = -np.sort(-logits, axis=1)[:, :K + 1]
        gaps = -np.diff(top, axis=1)
        sep = gaps[:, :K] > GAP
        sep[:, 1:] &= gaps[:, :K - 1] > GAP
        np.testing.assert_array_equal(pi[sep], ji[sep])
        ulp = np.exp2(np.floor(np.log2(np.maximum(
            np.maximum(np.abs(pv), np.abs(jv)), 1e-30))) - 7)
        assert (np.abs(pv - jv) <= ulp).all()
    assert make_teacher_config(CONFIG) == TEACHER


def test_distill_shard_source_joins_shards(tmp_path):
    store = logit_store.LogitStore(str(tmp_path), k=K, vocab=V)
    batches = [_distill_batch(i) for i in range(3)]
    for i, b in enumerate(batches):
        store.write_shard(i, b["topk_vals"], b["topk_idx"])
    items = list(train.distill_shard_source(batches, store, 1, 5, 0.1))
    assert len(items) == 2 and items[0].loss == "distill_topk"
    np.testing.assert_array_equal(items[1].data["topk_idx"].numpy(),
                                  batches[2]["topk_idx"])
    assert items[0].data["topk_vals"].dtype == torch.bfloat16


# ---------------------------------------------------------------- launcher

def test_launch_train_student_stage_on_the_host(tmp_path, capsys):
    res = launch_train.main(["--stage", "student", "--device", "cpu",
                             "--seed", "1", "--out", str(tmp_path)])
    assert res["updates"] == 12
    assert res["updates_by_loss"] == {"distill_topk": 8, "ce": 4}
    assert res["shards"] == 8 and res["device"] == "cpu"
    assert res["targets_wave"] == 0 and res["shard_copies"] == 8
    assert np.isfinite([res["loss_first"], res["loss_last"]]).all()
    assert len(res["gtc_density"]) == 12
    assert all(0 < d <= 1 for d in res["gtc_density"])
    assert json.loads((tmp_path / "train_student.json").read_text()) == res
    out = capsys.readouterr().out
    assert "12 updates" in out and "frames/s" in out and "gtc_density" in out
    res2 = launch_train.main(["--device", "cpu", "--steps", "3", "--seed",
                              "1", "--out", str(tmp_path / "b")])
    assert res2["updates"] == 3 and res2["loss_first"] == res["loss_first"]


def test_launch_train_targets_stage_on_the_host(tmp_path, capsys):
    """--stage targets: the reference's report keys, a verified v2 store
    of ragged shards, and a second run superseding at wave 1."""
    from repro_torch.store import LogitStoreV2
    argv = ["--stage", "targets", "--device", "cpu", "--seed", "2",
            "--out", str(tmp_path)]
    res = launch_train.main(argv)
    assert {"n_shards", "n_frames", "n_workers", "wave", "resumed",
            "storage_compression_x"} <= set(res)
    n, rows, frames = launch_train.TARGET_SIZES["reduced"]
    assert res["n_shards"] == res["n_written"] == n
    assert res["n_workers"] == 3 and res["wave"] == 0
    assert res["resumed"] is False and res["n_frames"] == n * rows * frames
    vocab = launch_train.reduced(
        launch_train.get_arch("lstm-am-teacher")).n_senones
    assert res["storage_compression_x"] == round(vocab * 4 / (20 * 6), 1)
    assert 0 < res["frames_written"] < res["n_frames"]
    assert res["frames_per_s"] > 0 and res["write_s"] > 0
    store = LogitStoreV2(str(tmp_path / "logit_store"))
    assert store.verify() == res["n_shards"]
    lens = [store.read_lens(j) for j in store.shards()]
    assert sum(int(x.sum()) for x in lens) == res["frames_written"]
    assert len({int(t) for x in lens for t in x}) > 1          # ragged
    assert json.loads((tmp_path / "train_targets.json").read_text()) == res
    assert "frames/s" in capsys.readouterr().out
    again = launch_train.main(argv + ["--workers", "2"])
    assert again["wave"] == 1 and again["n_workers"] == 2
    store = LogitStoreV2(str(tmp_path / "logit_store"))
    assert store.verify() == n
    assert all(store.manifest.entry(j).wave == 1 for j in store.shards())


def test_launch_train_baseline_stage_on_the_host(tmp_path, capsys):
    """--stage baseline: CE on the synthetic corpus under Local, the
    reference's _ce_source (chunked epochs, then the full-sequence
    fine-tune), final params in <out>/ckpt_baseline, resume state
    cleared."""
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.data import CorpusLoader, FeatureConfig, SynthConfig
    res = launch_train.main(["--stage", "baseline", "--device", "cpu",
                             "--seed", "2", "--out", str(tmp_path)])
    b = launch_train.BASELINE["reduced"]
    loader = CorpusLoader(synth=SynthConfig(n_senones=97, seed=2,
                                            **b["synth"]),
                          feat=FeatureConfig(n_mels=b["n_mels"]))
    chunked = [len(list(loader.chunked_batches(
        0, b["n_labeled"], batch_size=b["batch"], chunk_len=b["chunk_len"],
        offset=ep % 3, seed=ep))) for ep in range(b["epochs"])]
    full = len(list(loader.full_seq_batches(0, b["n_labeled"],
                                            batch_size=b["batch"] // 2)))
    assert res["updates"] == res["updates_run"] == sum(chunked) + full
    assert res["resumed_at"] is None and res["device"] == "cpu"
    assert np.isfinite([res["loss_first"], res["loss_last"]]).all()
    assert res["train_frames"] > 0 and res["frames_per_s"] > 0
    assert json.loads((tmp_path / "train_baseline.json").read_text()) == res
    assert CheckpointStore(str(tmp_path / "ckpt_baseline")).steps() == [0]
    assert CheckpointStore(str(tmp_path / "ckpt_baseline" / "state")
                           ).steps() == []
    assert "CE updates" in capsys.readouterr().out


def test_launch_train_bmuf_student_on_the_host(tmp_path, capsys):
    """--trainer bmuf: whole blocks of tau*W = 8 microbatches, one per
    sub-epoch and one per labeled pass at the reduced sizes."""
    res = launch_train.main(["--stage", "student", "--trainer", "bmuf",
                             "--device", "cpu", "--seed", "1", "--out",
                             str(tmp_path)])
    rows, frames, per_sub, per_pass = launch_train.SIZES["bmuf"]["reduced"]
    assert res["trainer"] == "bmuf" and res["microbatches"] == 8
    assert res["updates"] == 4
    assert res["updates_by_loss"] == {"distill_topk": 2, "ce": 2}
    assert res["shards"] == 2 * per_sub and res["shard_copies"] == 16
    assert res["train_frames"] == 4 * 8 * rows * frames
    assert np.isfinite([res["loss_first"], res["loss_last"]]).all()
    assert "gtc_density" not in res
    assert "(bmuf)" in capsys.readouterr().out


def test_launch_train_entry_points_need_cuda_or_cpu(tmp_path):
    if torch.cuda.is_available():
        return
    for argv in (["--stage", "baseline"], ["--trainer", "bmuf"],
                 ["--stage", "teacher"], ["--stage", "smbr"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            launch_train.main(argv + ["--out", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_train.stage_baseline(full=False, device=None,
                                    out=str(tmp_path))


@pytest.mark.parametrize("call,match", [
    (lambda out: launch_train.main(["--stage", "all", "--device", "cpu",
                                    "--out", out]), "step 7: the pipeline"),
    (lambda out: launch_train.main(["--stage", "all", "--full", "--trainer",
                                    "bmuf", "--device", "cpu", "--out", out]),
     "end to end"),
    (lambda out: launch_train.main(["--arch", "qwen2.5-3b", "--device", "cpu",
                                    "--out", out]), "not ported"),
    (lambda out: train.GTCShardMap(gtc.GTCConfig(n_workers=2), mesh="data"),
     "not ported yet.*step 8")])
def test_launch_train_unported_stages_raise(call, match, tmp_path):
    with pytest.raises(NotImplementedError, match=match):
        call(str(tmp_path))
