"""Port parity: elastic membership (``train/state.py:restack_workers``,
``resize`` on the strategies and the Trainer, cross-W resume,
``Trainer.fit(membership=)``, ``runtime/workers.py``'s
``TrainerMembership`` / ``LaneCrashPlan`` and ``SSLPipeline.run_waves``).

Inputs are made from a seed with numpy and go through the JAX reference
and the port.  Tolerances:
  * ``restack_workers`` and ``worker_dim``: bitwise against the
    reference's on the same trees (copies and in-order adds only).
  * The port against itself (the elastic kill against a cross-W resume):
    bitwise -- the same operations on the same values.
  * The port's elastic BMUF run against the reference's ``Trainer.fit(
    membership=LaneCrashPlan)`` on the quadratic loss of
    ``tests/test_elastic.py`` from the same initial params: ELASTIC_REL
    1e-6 of each value's size (float32, sum orders differ).
  * GTC's error mass across a resize, checked directly (the reference's
    own ``test_gtc_resize_conserves_residual`` fails under jax 0.9.0):
    the sends plus the final residuals equal the sum of all gradients to
    within half an ulp of the run's summed magnitudes per float32
    rounding on each value's path (two a compression, one for the
    wire's unpack, one for each row folded in).
  * Rosters: the same join/leave/kill sequence gives the same ``live()``
    in both packages; each reads a roster the other wrote.
No assertion depends on wall time: a plan's roster is made older than
its timeout by ageing the heartbeat files, which the port's plan must
survive.
"""
import dataclasses
import math
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import train as jtrain  # noqa: E402
from repro.checkpoint import CheckpointStore as JaxCheckpointStore  # noqa
from repro.distributed import bmuf as jbmuf  # noqa: E402
from repro.runtime import workers as jworkers  # noqa: E402
from repro.train.state import restack_workers as jax_restack  # noqa: E402
from repro.train.state import worker_dim as jax_worker_dim  # noqa: E402
from repro_torch import train  # noqa: E402
from repro_torch.checkpoint import CheckpointStore  # noqa: E402
from repro_torch.distributed import bmuf, gtc  # noqa: E402
from repro_torch.runtime import workers  # noqa: E402
from repro_torch.train.state import restack_workers, worker_dim  # noqa: E402

D = 8
ELASTIC_REL = 1e-6


def _tree(w, seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(w, 3)).astype(np.float32),
            "b": {"c": rng.normal(size=(w,)).astype(np.float32),
                  "d": rng.normal(size=(w, 2, 2)).astype(np.float32)}}


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _same(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _same(got[k], want[k])
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()


# ====================================================== restack_workers

@pytest.mark.parametrize("w,w_new", [(5, 2), (5, 3), (4, 1), (4, 4),
                                     (2, 3), (1, 4)])
@pytest.mark.parametrize("fold", [False, True])
def test_restack_workers_matches_the_reference(w, w_new, fold):
    tree = _tree(w, seed=w * 10 + w_new)
    want = _np(jax_restack(tree, w_new, fold=fold))
    got = restack_workers({k: (torch.from_numpy(v) if k == "a" else v)
                           for k, v in tree.items()}, w_new, fold=fold)
    _same(_np({k: (v.numpy() if torch.is_tensor(v) else _np(v))
               for k, v in got.items()}), want)
    if fold:          # the sum over the worker dim is kept
        for leaf in ("a",):
            np.testing.assert_allclose(
                np.asarray(got[leaf]).sum(0), tree[leaf].sum(0),
                rtol=1e-6, atol=1e-6)
    assert worker_dim(got) == jax_worker_dim(want) == w_new


def test_restack_bad_w_and_worker_dim():
    for restack in (restack_workers, jax_restack):
        with pytest.raises(ValueError):
            restack({"w": np.zeros((2, 3), np.float32)}, 0)
    for tree in ({"w": np.zeros((4, 3))}, {}, {"b": {"a": np.zeros((2,))},
                                                "c": np.zeros((5, 1))}):
        assert worker_dim(tree) == jax_worker_dim(
            jax.tree_util.tree_map(jnp.asarray, tree))


# ====================================================== strategies

def quad_loss(params, batch):
    e = torch.as_tensor(batch["x"]) @ params["w"] - torch.as_tensor(
        batch["y"])
    loss = torch.mean(e ** 2)
    return loss, {"loss": loss.detach()}


def jax_quad_loss(params, batch):
    e = batch["x"] @ params["w"] - batch["y"]
    return jnp.mean(e ** 2), {"loss": jnp.mean(e ** 2)}


def _problem(seed, n=16):
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=(D,))
    x = rng.normal(size=(n, D)).astype(np.float32)
    return {"x": x, "y": (x @ w_true).astype(np.float32)}


def _batches(n, seed0=100):
    return [_problem(seed0 + i) for i in range(n)]


def _src(batches, tb=train.TrainBatch):
    return [tb(b, 0.05, "quad") for b in batches]


def _w0(seed=7):
    return np.random.default_rng(seed).normal(size=(D,)).astype(np.float32)


def _bmuf_trainer(w, **kw):
    return train.Trainer(train.BMUFVmap(bmuf.BMUFConfig(
        n_workers=w, block_steps=1), clip=0.0), {"quad": quad_loss}, **kw)


def test_bmuf_resize_restacks_lanes_and_keeps_delta():
    tr = _bmuf_trainer(4)
    state = tr.init_state({"w": torch.from_numpy(_w0())})
    state = tr.fit(state, _src(_batches(8)), resume=False)
    lanes = state.strategy_state["workers"]["w"].clone()
    delta = state.strategy_state["delta"]["w"]
    small = tr.resize(state, 3)
    assert tr.strategy.n_workers == 3 and tr.strategy.microbatches == 3
    assert torch.equal(small.strategy_state["workers"]["w"], lanes[:3])
    assert small.strategy_state["delta"]["w"] is delta
    assert tuple(small.opt_state["mu"]["w"].shape) == (3, D)
    big = tr.resize(small, 5)
    assert torch.equal(big.strategy_state["workers"]["w"][3:],
                       lanes[:1].expand(2, D))
    assert tr.resize_stats["count"] == 2
    assert tr.resize(big, 5) is big                 # same W: nothing to do
    with pytest.raises(ValueError, match="single-worker"):
        train.Local().resize(state, 2)
    assert train.GTC().resize(state, 1) is state


def test_trainer_elastic_kill_matches_cross_w_resume(tmp_path):
    """Run A: W = 4 BMUF with a checkpoint at update 2, then a
    LaneCrashPlan kills lane3 (resize to W = 3 at the block boundary)
    and training goes on.  Run B: a fresh W = 3 trainer resumes the W = 4
    checkpoint.  Both reach update 4 with bitwise equal params."""
    ck = str(tmp_path / "ck")
    batches = _batches(4 * 2 + 3 * 2)
    params = {"w": torch.from_numpy(_w0())}
    tr_a = _bmuf_trainer(4, checkpoint=CheckpointStore(ck), ckpt_every=2)
    s_a = tr_a.fit(tr_a.init_state(params), _src(batches[:8]), resume=False)
    assert s_a.step == 2
    tr_a.ckpt_every = 0
    m = workers.TrainerMembership(str(tmp_path / "members.json"),
                                  timeout_s=3600.0)
    for i in range(4):
        m.join(f"lane{i}")
    plan = workers.LaneCrashPlan(m, kills={0: "lane3"})
    s_a = tr_a.fit(s_a, _src(batches[8:]), resume=False, membership=plan)
    assert s_a.step == 4 and tr_a.strategy.n_workers == 3
    assert tr_a.resize_stats["count"] == 1

    tr_b = _bmuf_trainer(3, checkpoint=CheckpointStore(ck))
    s_b = tr_b.fit(tr_b.init_state(params), _src(batches), resume=True)
    assert s_b.step == 4 and tr_b.resize_stats["count"] == 1
    for tree in ("params",):
        for n, x in getattr(s_a, tree).items():
            assert torch.equal(x, getattr(s_b, tree)[n])
    for n, x in s_a.strategy_state["workers"].items():
        assert torch.equal(x, s_b.strategy_state["workers"][n])


def test_elastic_run_matches_the_reference_and_grows_back(tmp_path):
    """Kill lane2 after update 1, revive it after update 3: both
    packages shrink to W = 3 and grow back to W = 4, fire the same
    events and end within ELASTIC_REL of each other."""
    batches = _batches(24)
    w0 = _w0()
    jm = jworkers.TrainerMembership(str(tmp_path / "j" / "members.json"),
                                    timeout_s=3600.0)
    pm = workers.TrainerMembership(str(tmp_path / "p" / "members.json"),
                                   timeout_s=3600.0)
    for i in range(4):
        jm.join(f"lane{i}")
        pm.join(f"lane{i}")
    jplan = jworkers.LaneCrashPlan(jm, kills={1: "lane2"},
                                   revives={3: "lane2"})
    pplan = workers.LaneCrashPlan(pm, kills={1: "lane2"},
                                  revives={3: "lane2"})
    jtr = jtrain.Trainer(jtrain.BMUFVmap(jbmuf.BMUFConfig(
        n_workers=4, block_steps=1), clip=0.0), {"quad": jax_quad_loss})
    js = jtr.fit(jtr.init_state({"w": jnp.asarray(w0)}),
                 _src([{k: jnp.asarray(v) for k, v in b.items()}
                       for b in batches], jtrain.TrainBatch),
                 resume=False, membership=jplan)
    ptr = _bmuf_trainer(4)
    ps = ptr.fit(ptr.init_state({"w": torch.from_numpy(w0)}),
                 _src(batches), resume=False, membership=pplan)
    assert ptr.strategy.n_workers == jtr.strategy.n_workers == 4
    assert ptr.resize_stats["count"] == jtr.resize_stats["count"] == 2
    assert pplan.log == jplan.log
    assert [e["event"] for e in pplan.log] == ["kill", "revive"]
    assert ps.step == int(js.step) >= 4
    for got, want in ((ps.params["w"], js.params["w"]),
                      (ps.strategy_state["delta"]["w"],
                       js.strategy_state["delta"]["w"]),
                      (ps.strategy_state["workers"]["w"],
                       js.strategy_state["workers"]["w"])):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=ELASTIC_REL,
                                   atol=ELASTIC_REL * np.abs(want).max())


def lin_loss(params, batch):
    loss = torch.sum(params["w"] * torch.as_tensor(batch["c"]))
    return loss, {"loss": loss.detach()}


def gtc_conservation(w_phases, *, tau=2e-3, rounds=3, d=16, seed=3):
    """GTCShardMap through ``w_phases`` (a resize between phases) on the
    linear loss whose gradient is its batch: -> (sum of grads, sum of
    sends, final residual sum, per-value tolerance), all float64."""
    strat = train.GTCShardMap(gtc.GTCConfig(tau=tau, n_workers=w_phases[0]),
                              clip=0.0)
    params = {"w": torch.zeros(d)}
    gstate = strat.init_state(params)
    rng = np.random.default_rng(seed)
    total_g, total_sent, mag = (np.zeros(d) for _ in range(3))
    roundings = 0
    for i, w in enumerate(w_phases):
        if i:
            before = gstate["residual"]["w"].double().sum(0)
            old = gstate["residual"]["w"].shape[0]
            ts = train.TrainState(params=params, opt_state=None,
                                  strategy_state=gstate, step=0, rng=0)
            gstate = strat.resize(ts, w).strategy_state
            assert gstate["residual"]["w"].shape[0] == w
            roundings += max(0, old - w)
            assert torch.allclose(gstate["residual"]["w"].double().sum(0),
                                  before, rtol=0, atol=1e-7)
        step = gtc.make_sharded_gtc_train_step(
            lin_loss, lambda p, u, o, lr: (u, o), strat.cfg)
        for _ in range(rounds):
            cs = [(rng.normal(size=(d,)) * tau).astype(np.float32)
                  for _ in range(w)]
            upd, _, gstate, _ = step(
                params, None, gstate,
                {"c": torch.from_numpy(np.stack(cs))}, 0.05)
            sent = w * upd["w"].double().numpy()
            total_g += sum(c.astype(np.float64) for c in cs)
            total_sent += sent
            mag += sum(np.abs(c.astype(np.float64)) for c in cs) \
                + np.abs(sent)
            roundings += 2 * w + 1
    res = gstate["residual"]["w"].double().sum(0).numpy()
    mag += np.abs(res)
    tol = roundings * 0.5 * np.spacing(mag.astype(np.float32)).astype(
        np.float64)
    return total_g, total_sent, res, tol


@pytest.mark.parametrize("w_phases", [(4, 2), (2, 1, 2), (1, 3)])
def test_gtc_resize_keeps_the_error_mass(w_phases):
    total_g, total_sent, res, tol = gtc_conservation(w_phases)
    assert np.abs(total_sent).max() > 0           # the wire sent
    assert (np.abs(total_sent + res - total_g) <= tol).all()


def test_gtc_cross_w_resume_keeps_the_residual_sum(tmp_path):
    """A GTC checkpoint saved at W = 4 resumes into a W = 2 trainer: the
    load goes through the saved-W template, the resize folds residuals
    keeping their sum, and training goes on."""
    ck = str(tmp_path / "ck")
    batch = _problem(0, n=32)

    def src(n):
        return [train.TrainBatch(batch, 0.05, "quad") for _ in range(n)]

    def mk(w, **kw):
        return train.Trainer(train.GTCShardMap(
            gtc.GTCConfig(tau=1e-3, n_workers=w), clip=0.0),
            {"quad": quad_loss}, checkpoint=CheckpointStore(ck), **kw)
    tr4 = mk(4, ckpt_every=2)
    s4 = tr4.fit(tr4.init_state({"w": torch.zeros(D)}), src(8),
                 resume=False)
    assert s4.step == 2
    res_sum = s4.strategy_state["residual"]["w"].double().sum(0)
    tr2 = mk(2)
    s2 = tr2.fit(tr2.init_state({"w": torch.zeros(D)}), src(8), resume=True)
    assert tr2.resize_stats["count"] == 1 and s2.step == 2
    assert s2.strategy_state["residual"]["w"].shape[0] == 2
    assert torch.equal(s4.params["w"], s2.params["w"])
    assert torch.allclose(s2.strategy_state["residual"]["w"].double().sum(0),
                          res_sum, rtol=0, atol=1e-7)
    s2 = tr2.fit(s2, src(4), resume=False)
    assert s2.step == 4


def test_the_reference_reads_a_port_cross_w_checkpoint(tmp_path):
    """A W = 4 BMUF checkpoint the port saved resumes in the reference's
    W = 2 trainer (its cross-W path), and the params are the port's."""
    ck = str(tmp_path / "ck")
    tr = _bmuf_trainer(4, checkpoint=CheckpointStore(ck), ckpt_every=1)
    s = tr.fit(tr.init_state({"w": torch.from_numpy(_w0())}),
               _src(_batches(4)), resume=False)
    jtr = jtrain.Trainer(jtrain.BMUFVmap(jbmuf.BMUFConfig(
        n_workers=2, block_steps=1), clip=0.0), {"quad": jax_quad_loss},
        checkpoint=JaxCheckpointStore(ck))
    js = jtr.fit(jtr.init_state({"w": jnp.zeros(D)}),
                 _src([{k: jnp.asarray(v) for k, v in b.items()}
                       for b in _batches(4)], jtrain.TrainBatch))
    assert int(js.step) == 1 and jtr.resize_stats["count"] == 1
    np.testing.assert_array_equal(np.asarray(js.params["w"]),
                                  s.params["w"].numpy())


# ================================================== membership machinery

@pytest.mark.parametrize("writer", ["port", "reference"])
def test_membership_matches_the_reference(writer, tmp_path):
    """The same join/leave/kill sequence, driven through one package's
    roster, reads the same ``live()`` through both."""
    path = str(tmp_path / "members.json")
    pm = workers.TrainerMembership(path, timeout_s=3600.0)
    jm = jworkers.TrainerMembership(path, timeout_s=3600.0)
    drive = pm if writer == "port" else jm
    seen = []
    for op, name in (("join", "a"), ("join", "b"), ("leave", "b"),
                     ("join", "c"), ("kill", "a"), ("join", "a"),
                     ("kill", "c")):
        getattr(drive, op)(name)
        seen.append((pm.live(), jm.live(), pm.live_count(),
                     jm.live_count()))
    for p_live, j_live, p_n, j_n in seen:
        assert p_live == j_live and p_n == j_n == len(p_live)
    assert seen[-1][0] == ["a"]
    assert pm.roster() == jm.roster()


def test_lane_crash_plan_matches_the_reference(tmp_path):
    counts, logs = [], []
    for mod, sub in ((workers, "p"), (jworkers, "j")):
        m = mod.TrainerMembership(str(tmp_path / sub / "m.json"),
                                  timeout_s=3600.0)
        m.join("a")
        m.join("b")
        plan = mod.LaneCrashPlan(m, kills={1: "b"}, revives={2: "b"})
        counts.append([plan.live_count() for _ in range(4)])
        logs.append(plan.log)
    assert counts[0] == counts[1] == [2, 1, 2, 2]
    assert logs[0] == logs[1]


def test_lane_crash_plan_outlives_its_roster_timeout(tmp_path):
    """Each poll comes later than the roster's timeout (every heartbeat
    aged past it, as a long block would): the reference's lanes, which
    beat only when they join, would all look dead; the port's plan beats
    the lanes its script holds live, so the count stays the script's."""
    m = workers.TrainerMembership(str(tmp_path / "m.json"), timeout_s=5.0)
    for lane in ("lane0", "lane1", "lane2"):
        m.join(lane)
    plan = workers.LaneCrashPlan(m, kills={1: "lane2"}, revives={3: "lane2"})
    got = []
    for _ in range(5):
        then = time.time() - 60.0           # a block of a minute
        for hb in os.listdir(m.heartbeat_dir):
            os.utime(os.path.join(m.heartbeat_dir, hb), (then, then))
        assert m.live_count() == 0
        got.append(plan.live_count())
    assert got == [3, 2, 2, 3, 3]


# ============================================================ the waves

def test_run_waves_end_to_end(tmp_path):
    """Two generate -> train -> promote waves at the reference test's
    config, one lane killed and revived in each: the reference's counts.
    The waves need a baseline and a teacher, not trained ones: both are
    their stage's initial params, and the corpus is featurized once (the
    loader is deterministic), so the test costs the waves alone."""
    from repro_torch.core.ssl_pipeline import PipelineConfig, SSLPipeline
    pc = dataclasses.replace(PipelineConfig.tiny(), bmuf_workers=4,
                             bmuf_block_steps=2, n_sub_epochs=4,
                             labeled_every=2, chunked_until=3)
    p = SSLPipeline(pc, out_dir=str(tmp_path / "waves"),
                    student_trainer="bmuf", device="cpu")
    featurized, cache = p.loader.featurized, {}

    def cached(start, count, *, offset=0):
        key = (start, count, offset)
        if key not in cache:
            cache[key] = featurized(start, count, offset=offset)
        return cache[key]
    p.loader.featurized = cached
    p._ckpt("baseline").save(0, p._init_params(p.student_cfg, pc.seed))
    p._ckpt("teacher").save(0, p._init_params(p.teacher_cfg, pc.seed + 1))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # 2x64 ops: threads only contend
    try:
        rep = p.run_waves(2, kill_at=1, revive_after=2)
    finally:
        torch.set_num_threads(threads)
    assert rep["n_waves"] == 2
    assert rep["manifest_clean"] and rep["ledger_clean"]
    assert rep["restarts_absorbed"] == 2
    assert rep["resize_count"] == 4
    assert [wv["wave"] for wv in rep["waves"]] == [0, 1]
    for wv in rep["waves"]:
        assert wv["student"]["final_workers"] == 4
        assert math.isfinite(wv["student"]["val_fer"])
    assert rep["n_verified"] == rep["waves"][0]["gen"]["n_shards"]
