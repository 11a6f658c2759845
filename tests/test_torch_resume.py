"""Port parity: TrainState checkpoints and mid-stage resume.

Inside the port, a run interrupted after a periodic checkpoint and
re-invoked lands bitwise on the uninterrupted run (``Local``, ``GTC``'s
residual, BMUF's ``delta`` and lanes, Schedule learning rates, a loss
that draws from its generator).  Across packages, both ways: a
TrainState checkpoint written by the JAX ``Trainer`` (``Local`` and
``BMUFVmap``) is resumed by the port and one written by the port is
resumed by JAX; the next update matches the other package's
uninterrupted run within the three-update test's bar (1e-5).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import train as jtrain  # noqa: E402
from repro.checkpoint import CheckpointStore as JaxCheckpointStore  # noqa: E402
from repro.configs.base import LayerSpec as JaxLayerSpec  # noqa: E402
from repro.configs.base import Segment as JaxSegment  # noqa: E402
from repro.configs.lstm_am_7khr import CONFIG as JAX_CONFIG  # noqa: E402
from repro.distributed import bmuf as jbmuf  # noqa: E402
from repro.launch.steps import make_loss_fn as jax_make_loss_fn  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch import train  # noqa: E402
from repro_torch.checkpoint import CheckpointStore, params_from_numpy  # noqa: E402
from repro_torch.configs.base import LayerSpec, Segment  # noqa: E402
from repro_torch.configs.lstm_am_7khr import CONFIG  # noqa: E402
from repro_torch.distributed import bmuf  # noqa: E402
from repro_torch.distributed.gtc import GTCConfig  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import exponential_decay  # noqa: E402
from repro_torch.train.state import key_data, seed_of  # noqa: E402

D = 8
F, H, V, K = 12, 32, 97, 20
B, S = 4, 8
TOL = dict(rtol=1e-5, atol=1e-5)


def quad_loss(params, batch):
    e = torch.as_tensor(batch["x"]) @ params["w"] - torch.as_tensor(
        batch["y"])
    return torch.mean(e ** 2), {"loss": torch.mean(e ** 2).detach()}


def noisy_loss(params, batch, rng):
    y = torch.as_tensor(batch["y"])
    noise = torch.randn(y.shape, generator=rng) * 0.01
    e = torch.as_tensor(batch["x"]) @ params["w"] - (y + noise)
    return torch.mean(e ** 2), {"loss": torch.mean(e ** 2).detach(),
                                "n0": noise.reshape(-1)[0]}


def _problem(seed=0, n=64):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, D)).astype(np.float32)
    y = (x @ rng.normal(size=(D,))).astype(np.float32)
    return {"x": x, "y": y}


def _params():
    return {"w": torch.zeros(D)}


def _source(batch, lrs, loss="quad"):
    return [train.TrainBatch(batch, lr, loss) for lr in lrs]


def _equal(a, b):
    """Bitwise equality of two nested dicts of tensors."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _equal(a[k], b[k])
    else:
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


# ---------------------------------------------------- resume in the port

def test_fit_resumes_from_periodic_checkpoint(tmp_path):
    """Kill-and-reinvoke: a run interrupted after the step-4 checkpoint
    resumes there and lands bitwise on the uninterrupted result;
    finalize() retires the resume state."""
    batch = _problem(n=64)
    lrs = [0.05 * (0.9 ** i) for i in range(10)]
    ref = train.Trainer(train.Local(clip=0.0), {"quad": quad_loss})
    ref_state = ref.fit(ref.init_state(_params()), _source(batch, lrs))

    store = CheckpointStore(os.path.join(tmp_path, "state"))
    t1 = train.Trainer(train.Local(clip=0.0), {"quad": quad_loss},
                       checkpoint=store, ckpt_every=2)
    t1.fit(t1.init_state(_params()), _source(batch, lrs), max_updates=5)
    assert store.latest() == 4
    assert store.load_meta(4) == {"step": 4, "consumed": 4, "n_workers": 1}

    sink = train.ListSink()
    t2 = train.Trainer(train.Local(clip=0.0), {"quad": quad_loss},
                       checkpoint=store, ckpt_every=2, metrics=sink)
    state = t2.fit(t2.init_state(_params()), _source(batch, lrs))
    assert state.step == 10
    assert len(sink) == 6                    # steps 5..10 only
    assert torch.equal(state.params["w"], ref_state.params["w"])
    _equal(state.opt_state, ref_state.opt_state)
    t2.finalize(state)
    assert store.latest() is None


@pytest.mark.parametrize("strategy", ["gtc", "bmuf"])
def test_resume_preserves_strategy_state(tmp_path, strategy):
    """GTC's residual and BMUF's block momentum and lanes (and the lanes'
    momentum) survive the checkpoint boundary, bitwise."""
    batch = _problem(n=32)

    def mk_strategy():
        if strategy == "gtc":
            return train.GTC(GTCConfig(tau=1e-3, n_workers=1), clip=0.0)
        return train.BMUFVmap(bmuf.BMUFConfig(n_workers=2, block_steps=2),
                              clip=0.0)

    per = 1 if strategy == "gtc" else 4
    src = lambda: _source(batch, [0.05] * 6 * per)  # noqa: E731
    ref = train.Trainer(mk_strategy(), {"quad": quad_loss})
    ref_state = ref.fit(ref.init_state(_params()), src())
    store = CheckpointStore(os.path.join(tmp_path, "state"))
    mk = lambda: train.Trainer(mk_strategy(), {"quad": quad_loss},  # noqa
                               checkpoint=store, ckpt_every=2)
    t1 = mk()
    t1.fit(t1.init_state(_params()), src(), max_updates=3)
    assert store.latest() == 2
    assert store.load_meta(2)["consumed"] == 2 * per
    t2 = mk()
    state = t2.fit(t2.init_state(_params()), src())
    assert state.step == ref_state.step == 6
    _equal(state.strategy_state, ref_state.strategy_state)
    _equal(state.opt_state, ref_state.opt_state)
    assert torch.equal(state.params["w"], ref_state.params["w"])
    if strategy == "bmuf":
        assert tuple(state.strategy_state["workers"]["w"].shape) == (2, D)


def test_schedule_through_epoch_source_and_resume(tmp_path):
    """epoch_source passes Schedule objects through, and a resumed run
    continues the schedule at the right step, bitwise."""
    batch = _problem(n=32)
    mk_src = lambda: train.epoch_source(  # noqa: E731
        lambda ep: [batch] * 3, 2, exponential_decay(0.1, 0.7, 1), "quad")
    assert all(callable(tb.lr) for tb in mk_src())
    ref = train.Trainer(train.Local(clip=0.0), {"quad": quad_loss})
    ref_state = ref.fit(ref.init_state(_params()), mk_src())
    store = CheckpointStore(os.path.join(tmp_path, "state"))
    t1 = train.Trainer(train.Local(clip=0.0), {"quad": quad_loss},
                       checkpoint=store, ckpt_every=2)
    t1.fit(t1.init_state(_params()), mk_src(), max_updates=3)
    t2 = train.Trainer(train.Local(clip=0.0), {"quad": quad_loss},
                       checkpoint=store, ckpt_every=2)
    state = t2.fit(t2.init_state(_params()), mk_src())
    assert torch.equal(state.params["w"], ref_state.params["w"])


def test_stochastic_loss_resume_is_bitwise(tmp_path):
    """A loss that draws from its generator: a distinct stream per
    update, and a killed-and-reinvoked run lands bitwise on the
    uninterrupted one (the fold depends only on checkpointed state)."""
    batch = _problem(n=32)
    lrs = [0.05] * 8
    sink = train.ListSink()
    ref = train.Trainer(train.Local(clip=0.0), {"noisy": noisy_loss},
                        metrics=sink)
    ref_state = ref.fit(ref.init_state(_params(), seed=3),
                        _source(batch, lrs, "noisy"))
    assert len(set(sink.values("n0"))) == 8
    store = CheckpointStore(os.path.join(tmp_path, "state"))
    t1 = train.Trainer(train.Local(clip=0.0), {"noisy": noisy_loss},
                       checkpoint=store, ckpt_every=2)
    t1.fit(t1.init_state(_params(), seed=3), _source(batch, lrs, "noisy"),
           max_updates=5)
    t2 = train.Trainer(train.Local(clip=0.0), {"noisy": noisy_loss},
                       checkpoint=store, ckpt_every=2)
    state = t2.fit(t2.init_state(_params(), seed=3),
                   _source(batch, lrs, "noisy"))
    assert state.step == 8
    assert torch.equal(state.params["w"], ref_state.params["w"])


def test_resume_at_another_worker_count_raises(tmp_path):
    batch = _problem(n=16)
    store = CheckpointStore(os.path.join(tmp_path, "state"))

    def mk(w):
        return train.Trainer(
            train.BMUFVmap(bmuf.BMUFConfig(n_workers=w, block_steps=1),
                           clip=0.0), {"quad": quad_loss},
            checkpoint=store, ckpt_every=1)

    t1 = mk(2)
    t1.fit(t1.init_state(_params()), _source(batch, [0.05] * 2))
    assert store.load_meta(1)["n_workers"] == 2
    t2 = mk(4)
    with pytest.raises(NotImplementedError, match="step 8"):
        t2.fit(t2.init_state(_params()), _source(batch, [0.05] * 4))
    assert store.latest() == 1               # nothing was loaded or saved


@pytest.mark.parametrize("seed", [0, 3, 2 ** 31, 2 ** 32 - 1])
def test_rng_key_data_is_the_reference_key(seed):
    want = np.asarray(jax.random.key_data(jax.random.key(seed)))
    np.testing.assert_array_equal(key_data(seed), want)
    assert key_data(seed).dtype == np.uint32
    assert seed_of(want) == seed
    st = train.TrainState({"w": torch.zeros(2)}, {}, {}, 5,
                          torch.Generator().manual_seed(seed))
    back = train.TrainState.from_dict(st.to_dict())
    assert back.rng == seed and back.step == 5


@pytest.mark.parametrize("seed", [-1, 2 ** 32])
def test_rng_outside_the_reference_key_raises(seed):
    with pytest.raises(ValueError, match="32"):
        key_data(seed)


def test_trainstate_checkpoint_layout(tmp_path):
    """The port's TrainState file: the reference's ``t::`` paths, an
    int32 step and uint32 rng, W-stacked BMUF leaves."""
    tr = train.Trainer(train.BMUFVmap(bmuf.BMUFConfig(n_workers=3,
                                                      block_steps=1)),
                       {"quad": quad_loss})
    state = tr.init_state({"b.c": torch.zeros(4), "a": torch.ones(2, 2)},
                          seed=9)
    store = CheckpointStore(str(tmp_path))
    store.save(0, state.to_dict())
    with np.load(store.path(0)) as z:
        files = {k: (z[k].shape, z[k].dtype) for k in z.files}
        assert list(z.files) == sorted(z.files, key=lambda p: p.split("/"))
        np.testing.assert_array_equal(z["t::rng"], [0, 9])
    assert files == {
        "t::params/a": ((2, 2), np.float32), "t::params/b/c": ((4,),
                                                               np.float32),
        "t::opt/mu/a": ((3, 2, 2), np.float32),
        "t::opt/mu/b/c": ((3, 4), np.float32),
        "t::strategy/delta/a": ((2, 2), np.float32),
        "t::strategy/delta/b/c": ((4,), np.float32),
        "t::strategy/workers/a": ((3, 2, 2), np.float32),
        "t::strategy/workers/b/c": ((3, 4), np.float32),
        "t::step": ((), np.int32), "t::rng": ((2,), np.uint32)}
    back, _ = store.load(state.to_dict())
    _equal(back["strategy"], state.strategy_state)
    assert back["step"] == 0 and seed_of(back["rng"]) == 9


# --------------------------------------------------- across the packages

def _cfg(base, seg_cls, spec_cls):
    return base.replace(
        lstm_hidden=H, feat_dim=F, n_senones=V, vocab_size=V,
        segments=(seg_cls((spec_cls(mixer="lstm", ffn="none"),), repeat=2),))


def _flat(tree) -> dict:
    return {".".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def student():
    jcfg = _cfg(JAX_CONFIG, JaxSegment, JaxLayerSpec)
    pcfg = _cfg(CONFIG, Segment, LayerSpec)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.key(8))
    pp = params_from_numpy(jax.device_get(jp), pcfg, device="cpu")
    return jcfg, jm, jp, pcfg, build_model(pcfg, device="cpu", params=pp), pp


def _ce_batch(seed):
    rng = np.random.default_rng(seed)
    return {"feats": rng.normal(size=(B, S, F)).astype(np.float32),
            "labels": rng.integers(0, V, (B, S)).astype(np.int32),
            "mask": np.ones((B, S), np.float32)}


def _distill_batch(seed):
    rng = np.random.default_rng(seed)
    vals = -np.sort(-rng.normal(size=(B, S, K)) * 3, axis=-1)
    idx = np.stack([rng.permutation(V)[:K] for _ in range(B * S)])
    return {"feats": rng.normal(size=(B, S, F)).astype(np.float32),
            "mask": np.ones((B, S), np.float32),
            "topk_vals": (vals - vals[..., :1]).astype(np.float32),
            "topk_idx": idx.reshape(B, S, K).astype(np.int32)}


def _trainers(student, strategy, ckpt_dir):
    jcfg, jm, _, pcfg, pm, _ = student
    kinds = ("distill_topk", "ce")
    if strategy == "bmuf":
        js = jtrain.BMUFVmap(jbmuf.BMUFConfig(n_workers=2, block_steps=1))
        ps = train.BMUFVmap(bmuf.BMUFConfig(n_workers=2, block_steps=1))
    else:
        js, ps = jtrain.Local(), train.Local()
    jtr = jtrain.Trainer(js, {k: jax_make_loss_fn(jm, jcfg, k)
                              for k in kinds},
                         checkpoint=JaxCheckpointStore(ckpt_dir),
                         ckpt_every=1)
    ptr = train.Trainer(ps, {k: steps.make_loss_fn(pm, pcfg, k)
                             for k in kinds},
                        checkpoint=CheckpointStore(ckpt_dir), ckpt_every=1)
    return jtr, ptr


def _items(strategy):
    per = 2 if strategy == "bmuf" else 1
    return ([("ce", _ce_batch(40 + i), 0.05) for i in range(per)]
            + [("distill_topk", _distill_batch(50 + i), 0.04)
               for i in range(per)])


def _compare(pstate, jstate):
    assert pstate.step == int(jstate.step) == 2
    pd, jd = pstate.to_dict(), jax.device_get(jstate.to_dict())
    for key in ("params", "opt", "strategy"):
        jflat = {}
        for path, v in jax.tree_util.tree_leaves_with_path(jd[key]):
            jflat[".".join(k.key for k in path)] = np.asarray(v)
        pflat = {}

        def walk(prefix, node):
            for k, v in node.items():
                if isinstance(v, dict):
                    walk(prefix + k + ".", v)
                else:
                    pflat[prefix + k] = v.numpy()
        walk("", pd[key])
        assert sorted(pflat) == sorted(jflat), key
        for n, a in jflat.items():
            np.testing.assert_allclose(pflat[n], a, **TOL,
                                       err_msg=f"{key}/{n}")


@pytest.mark.parametrize("strategy", ["local", "bmuf"])
def test_port_resumes_a_jax_checkpoint(student, strategy, tmp_path):
    """JAX takes update 1 and checkpoints it; the port resumes from that
    file and takes update 2, within 1e-5 of JAX's uninterrupted run."""
    _, _, jp, _, _, pp = student
    items = _items(strategy)
    jtr, ptr = _trainers(student, strategy, str(tmp_path))
    per = len(items) // 2
    jtr.fit(jtr.init_state(jp), [jtrain.TrainBatch(b, lr, k)
                                 for k, b, lr in items], max_updates=1)
    assert JaxCheckpointStore(str(tmp_path)).load_meta(1)["consumed"] == per
    pstate = ptr.fit(ptr.init_state(pp), [train.TrainBatch(b, lr, k)
                                          for k, b, lr in items])
    ref, _ = _trainers(student, strategy, str(tmp_path / "ref"))
    jstate = ref.fit(ref.init_state(jp), [jtrain.TrainBatch(b, lr, k)
                                          for k, b, lr in items],
                     resume=False)
    _compare(pstate, jstate)


@pytest.mark.parametrize("strategy", ["local", "bmuf"])
def test_jax_resumes_a_port_checkpoint(student, strategy, tmp_path):
    """The port takes update 1 and checkpoints it; JAX resumes from that
    file and takes update 2, within 1e-5 of the port's uninterrupted
    run."""
    _, _, jp, _, _, pp = student
    items = _items(strategy)
    jtr, ptr = _trainers(student, strategy, str(tmp_path))
    ptr.fit(ptr.init_state(pp), [train.TrainBatch(b, lr, k)
                                 for k, b, lr in items], max_updates=1)
    jstate = jtr.fit(jtr.init_state(jp), [jtrain.TrainBatch(b, lr, k)
                                          for k, b, lr in items])
    _, ref = _trainers(student, strategy, str(tmp_path / "ref"))
    pstate = ref.fit(ref.init_state(pp), [train.TrainBatch(b, lr, k)
                                          for k, b, lr in items],
                     resume=False)
    _compare(pstate, jstate)


# ------------------------------------------------------------- launcher

def _killed_after(n_items):
    """A scheduled_source that raises after its first ``n_items``."""
    from repro_torch.launch import train as launch_train
    real = launch_train.scheduled_source

    def source(*args, **kwargs):
        for i, tb in enumerate(real(*args, **kwargs)):
            if i == n_items:
                raise RuntimeError("killed")
            yield tb

    return source


@pytest.mark.parametrize("trainer,prefetch", [("gtc", 0), ("bmuf", 2)])
def test_killed_student_stage_resumes_bitwise(tmp_path, monkeypatch,
                                              trainer, prefetch):
    """A student stage killed after its 2nd update (its source raises)
    and re-invoked resumes from the update-2 checkpoint and ends with
    parameters bitwise equal to an uninterrupted run's; the stage's end
    clears the resume state."""
    from repro_torch.launch import train as launch_train
    kw = dict(full=False, device="cpu", seed=4, trainer=trainer,
              ckpt_every=1, prefetch=prefetch, log=lambda _m: None)
    whole = launch_train.stage_student(out=str(tmp_path / "whole"), **kw)
    per = 8 if trainer == "bmuf" else 1
    killed = str(tmp_path / "killed")
    with monkeypatch.context() as m:
        m.setattr(launch_train, "scheduled_source", _killed_after(2 * per))
        with pytest.raises(RuntimeError, match="killed"):
            launch_train.stage_student(out=killed, **kw)
    store = CheckpointStore(os.path.join(killed, f"ckpt_student_{trainer}",
                                         "state"))
    assert store.latest() == 2
    assert store.load_meta(2)["consumed"] == 2 * per
    again = launch_train.stage_student(out=killed, **kw)
    assert again.results["resumed_at"] == 2
    # the resumed stage reads the completed targets pass it trained on
    assert again.results["targets_written"] == 0
    assert again.results["targets_wave"] == whole.results["targets_wave"]
    assert again.results["updates"] == whole.results["updates"]
    assert again.results["updates_run"] == whole.results["updates"] - 2
    assert again.state.step == whole.state.step
    _equal(again.state.params, whole.state.params)
    _equal(again.state.opt_state, whole.state.opt_state)
    _equal(again.state.strategy_state, whole.state.strategy_state)
    assert store.latest() is None
