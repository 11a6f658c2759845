"""Port parity: BMUF (``distributed/bmuf.py``, ``BMUFVmap``).

The same weights, microbatches and block configs go through the JAX
reference (``jax.vmap`` over the W lanes) and the port (a loop over the
W lanes on one device): the block sync alone within 1e-6, and two whole
blocks of ``Trainer.fit`` (a CE block, then a distill block) within the
three-update test's bar (1e-5, float32 with different sum orders) on
theta_g, delta, every lane and every lane's momentum.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import train as jtrain  # noqa: E402
from repro.configs.base import LayerSpec as JaxLayerSpec  # noqa: E402
from repro.configs.base import Segment as JaxSegment  # noqa: E402
from repro.configs.lstm_am_7khr import CONFIG as JAX_CONFIG  # noqa: E402
from repro.distributed import bmuf as jbmuf  # noqa: E402
from repro.launch.steps import make_loss_fn as jax_make_loss_fn  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch import train  # noqa: E402
from repro_torch.checkpoint import params_from_numpy  # noqa: E402
from repro_torch.configs.base import LayerSpec, Segment  # noqa: E402
from repro_torch.configs.lstm_am_7khr import CONFIG  # noqa: E402
from repro_torch.distributed import bmuf  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

F, H, V, K = 12, 32, 97, 20
B, S = 4, 8
TOL = dict(rtol=1e-5, atol=1e-5)
SYNC_TOL = dict(rtol=1e-6, atol=1e-6)


def _cfg(base, seg_cls, spec_cls):
    return base.replace(
        lstm_hidden=H, feat_dim=F, n_senones=V, vocab_size=V,
        segments=(seg_cls((spec_cls(mixer="lstm", ffn="none"),), repeat=2),))


def _flat(tree) -> dict:
    """A JAX tree -> {dotted name: numpy array}."""
    return {".".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def student():
    jcfg = _cfg(JAX_CONFIG, JaxSegment, JaxLayerSpec)
    pcfg = _cfg(CONFIG, Segment, LayerSpec)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.key(5))
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


# ------------------------------------------------------------ block sync

@pytest.mark.parametrize("w", [2, 4])
@pytest.mark.parametrize("nesterov", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_block_sync_matches_jax(w, nesterov, masked):
    rng = np.random.default_rng(w * 10 + nesterov)
    shapes = {"a": (5, 7), "b.c": (11,), "b.d": (3, 2, 4)}
    theta = {n: rng.normal(size=s).astype(np.float32)
             for n, s in shapes.items()}
    delta = {n: rng.normal(size=s).astype(np.float32) * 0.1
             for n, s in shapes.items()}
    workers = {n: (theta[n] + rng.normal(size=(w,) + s) * 0.05)
               .astype(np.float32) for n, s in shapes.items()}
    active = np.array([1, 0, 1, 1][:w], np.float32) if masked else None
    jcfg = jbmuf.BMUFConfig(n_workers=w, block_steps=2, block_momentum=0.7,
                            block_lr=0.9, nesterov=nesterov)
    pcfg = bmuf.BMUFConfig(n_workers=w, block_steps=2, block_momentum=0.7,
                           block_lr=0.9, nesterov=nesterov)

    def nest(flat):
        return {"a": flat["a"], "b": {"c": flat["b.c"], "d": flat["b.d"]}}

    jout = jbmuf.block_sync(
        {"theta_g": nest(theta), "delta": nest(delta),
         "workers": nest(workers)}, jcfg, active=active)
    pout = bmuf.block_sync(
        {k: {n: torch.from_numpy(v[n]) for n in shapes}
         for k, v in (("theta_g", theta), ("delta", delta),
                      ("workers", workers))}, pcfg, active=active)
    for key in ("theta_g", "delta", "workers"):
        for n, a in _flat(jout[key]).items():
            np.testing.assert_allclose(pout[key][n].numpy(), a, **SYNC_TOL,
                                       err_msg=f"{key}/{n}")
    # the restart reaches every lane, dead ones included
    for n in shapes:
        assert all(torch.equal(pout["workers"][n][i],
                               pout["workers"][n][0]) for i in range(w))


def test_bmuf_init_and_active_mean_match_jax():
    p = {"w": np.arange(6, dtype=np.float32).reshape(2, 3)}
    jst = jbmuf.bmuf_init({"w": jnp.asarray(p["w"])},
                          jbmuf.BMUFConfig(n_workers=3))
    pst = bmuf.bmuf_init({"w": torch.from_numpy(p["w"])},
                         bmuf.BMUFConfig(n_workers=3))
    for key in ("delta", "workers"):
        np.testing.assert_array_equal(pst[key]["w"].numpy(),
                                      np.asarray(jst[key]["w"]))
    x = np.random.default_rng(0).normal(size=(3, 4)).astype(np.float32)
    for act in ([1, 0, 1], [0, 0, 0]):
        np.testing.assert_allclose(
            bmuf.active_mean_fn(act)(torch.from_numpy(x)).numpy(),
            np.asarray(jbmuf.active_mean_fn(act)(jnp.asarray(x))),
            **SYNC_TOL)


# --------------------------------------------------- whole blocks vs JAX

@pytest.mark.parametrize("w", [2, 4])
def test_two_blocks_match_jax(student, w):
    """A CE block, then a distill block (tau = 2) through both Trainers
    from one set of weights: theta_g, delta, every lane and every lane's
    momentum within 1e-5, the per-update metrics averaged over (W, tau)
    likewise."""
    jcfg, jm, jp, pcfg, pm, pp = student
    tau = 2
    n = tau * w
    micro = ([("ce", _ce_batch(100 + i), 0.05) for i in range(n)]
             + [("distill_topk", _distill_batch(200 + i), 0.04)
                for i in range(n)])
    kinds = ("distill_topk", "ce")
    jsink, psink = jtrain.ListSink(), train.ListSink()
    jtr = jtrain.Trainer(
        jtrain.BMUFVmap(jbmuf.BMUFConfig(n_workers=w, block_steps=tau)),
        {k: jax_make_loss_fn(jm, jcfg, k) for k in kinds}, metrics=jsink)
    ptr = train.Trainer(
        train.BMUFVmap(bmuf.BMUFConfig(n_workers=w, block_steps=tau)),
        {k: steps.make_loss_fn(pm, pcfg, k) for k in kinds}, metrics=psink)
    jstate = jtr.fit(jtr.init_state(jp), [jtrain.TrainBatch(b, lr, k)
                                          for k, b, lr in micro],
                     resume=False)
    pstate = ptr.fit(ptr.init_state(pp), [train.TrainBatch(b, lr, k)
                                          for k, b, lr in micro])
    assert pstate.step == int(jstate.step) == 2
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(psink.values(key), jsink.values(key),
                                   **TOL)
    pairs = [("params", pstate.params, jstate.params),
             ("delta", pstate.strategy_state["delta"],
              jstate.strategy_state["delta"]),
             ("workers", pstate.strategy_state["workers"],
              jstate.strategy_state["workers"]),
             ("mu", pstate.opt_state["mu"], jstate.opt_state["mu"])]
    for what, pt, jt in pairs:
        jflat = _flat(jt)
        assert list(pt) == list(jflat), what
        for name, a in jflat.items():
            assert tuple(pt[name].shape) == a.shape, (what, name)
            np.testing.assert_allclose(pt[name].numpy(), a, **TOL,
                                       err_msg=f"{what}/{name}")
    # momentum is per lane: the lanes saw different data
    mu = next(iter(pstate.opt_state["mu"].values()))
    assert not torch.equal(mu[0], mu[1])


def test_stack_order_is_tau_major(student):
    """Microbatch i of a group goes to local step i // W of lane i % W,
    as the reference's ``reshape(tau, w, ...)``."""
    tau, w = 2, 3
    group = [{"x": np.full((2, 2), i, np.float32)} for i in range(tau * w)]
    pst = train.BMUFVmap(bmuf.BMUFConfig(n_workers=w, block_steps=tau))
    jst = jtrain.BMUFVmap(jbmuf.BMUFConfig(n_workers=w, block_steps=tau))
    got = pst.stack(group)["x"]
    assert tuple(got.shape) == (tau, w, 2, 2)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jst.stack(group)["x"]))
    for i in range(tau * w):
        assert float(got[i // w, i % w, 0, 0]) == i
    assert pst.microbatches == tau * w and pst.n_workers == w


def test_block_lanes_see_their_microbatches():
    """Driving the block step by hand: lane w's local step i trains on
    the stacked batch's [i, w], with a generator unique per (lane, i)."""
    seen = []

    def step(p, o, b, lr, rng=None):
        seen.append((float(b["x"][0]), rng.initial_seed()))
        return {n: v + 1 for n, v in p.items()}, o, {"loss":
                                                     torch.tensor(1.0)}

    cfg = bmuf.BMUFConfig(n_workers=2, block_steps=3)
    state = bmuf.bmuf_init({"w": torch.zeros(2)}, cfg)
    opt = {"mu": {"w": torch.zeros(2, 2)}}
    batches = {"x": torch.arange(6.0).reshape(3, 2, 1)}
    block = bmuf.make_bmuf_block_step(step, cfg)
    out, _, ms = block(state, opt, batches, 0.1, rng=7)
    assert [x for x, _ in seen] == [0.0, 2.0, 4.0, 1.0, 3.0, 5.0]
    assert len({s for _, s in seen}) == 6
    assert tuple(ms["loss"].shape) == (2, 3)
    # every lane moved by tau; the block average and the restart follow
    np.testing.assert_allclose(out["delta"]["w"].numpy(), [3.0, 3.0])


def test_bmuf_fit_matches_manual_block_step():
    """BMUFVmap through Trainer.fit == the block step driven by hand."""
    cfg = bmuf.BMUFConfig(n_workers=2, block_steps=2, block_momentum=0.5)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(64, 8)).astype(np.float32)
    y = (x @ rng.normal(size=(8,))).astype(np.float32)
    micro = []
    for _ in range(8):
        sel = rng.integers(0, 64, (16,))
        micro.append({"x": x[sel], "y": y[sel]})

    def quad(params, batch):
        e = torch.as_tensor(batch["x"]) @ params["w"] - \
            torch.as_tensor(batch["y"])
        return torch.mean(e ** 2), {"loss": torch.mean(e ** 2).detach()}

    tr = train.Trainer(train.BMUFVmap(cfg, clip=0.0), {"quad": quad})
    state = tr.fit(tr.init_state({"w": torch.zeros(8)}),
                   [train.TrainBatch(m, 0.05, "quad") for m in micro])
    assert state.step == 2

    block = bmuf.make_bmuf_block_step(train.make_sgd_step(quad, clip=0.0),
                                      cfg)
    bstate = bmuf.bmuf_init({"w": torch.zeros(8)}, cfg)
    opt = {"mu": {"w": torch.zeros(2, 8)}}
    strat = train.BMUFVmap(cfg)
    for blk in range(2):
        bstate, opt, _ = block(bstate, opt,
                               strat.stack(micro[blk * 4:(blk + 1) * 4]),
                               0.05)
    assert torch.equal(state.params["w"], bstate["theta_g"]["w"])


def _quad(params, batch):
    e = torch.as_tensor(batch["x"]) @ params["w"] - torch.as_tensor(
        batch["y"])
    return torch.mean(e ** 2), {"loss": torch.mean(e ** 2).detach()}


def test_bmuf_partial_block_dropped_at_loss_boundary():
    """A block cannot straddle a loss-kind change: the partial group is
    dropped, and full blocks on either side still run."""
    cfg = bmuf.BMUFConfig(n_workers=2, block_steps=1)
    rng = np.random.default_rng(0)
    batch = {"x": rng.normal(size=(16, 8)).astype(np.float32),
             "y": rng.normal(size=(16,)).astype(np.float32)}
    src = ([train.TrainBatch(batch, 0.05, "quad")] * 2      # a full block
           + [train.TrainBatch(batch, 0.05, "quad")]        # partial
           + [train.TrainBatch(batch, 0.05, "other")] * 2)  # a full block
    tr = train.Trainer(train.BMUFVmap(cfg, clip=0.0),
                       {"quad": _quad, "other": _quad})
    state = tr.fit(tr.init_state({"w": torch.zeros(8)}), src)
    assert state.step == 2


def test_bmuf_partial_block_dropped_at_shape_and_lr_boundary():
    """The same for a batch-shape change and an lr change; a Schedule
    object compares by identity, so one schedule never splits a block,
    while an equal one re-created per item does."""
    from repro_torch.optim import exponential_decay
    cfg = bmuf.BMUFConfig(n_workers=2, block_steps=1)
    rng = np.random.default_rng(1)

    def b(n):
        return {"x": rng.normal(size=(n, 8)).astype(np.float32),
                "y": rng.normal(size=(n,)).astype(np.float32)}

    tb = train.TrainBatch
    sched = exponential_decay(0.1, 0.5, 2)
    src = ([tb(b(16), 0.05, "quad"), tb(b(8), 0.05, "quad")]      # shape
           + [tb(b(16), 0.05, "quad"), tb(b(16), 0.04, "quad")]   # lr
           + [tb(b(16), sched, "quad")] * 2                       # one
           + [tb(b(16), exponential_decay(0.1, 0.5, 2), "quad")   # equal,
              for _ in range(2)])                                 # not same
    tr = train.Trainer(train.BMUFVmap(cfg, clip=0.0), {"quad": _quad})
    state = tr.fit(tr.init_state({"w": torch.zeros(8)}), src)
    assert state.step == 1
