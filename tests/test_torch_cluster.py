"""Port parity: the paper's two trainers across OS processes (step 8b).

``runtime/cluster.py`` (``ClusterConfig``, ``initialize``, ``worker_mesh``)
and ``runtime/env.py`` against the reference's; then two gloo ranks on
the host, each a fresh interpreter running ``tests/torch_cluster_ranks.py``
(one OpenMP thread, a hard timeout, spawned once for the module) or the
launcher, held to the one-device loop and to the reference:

* GTC (``make_sharded_gtc_train_step`` on ``worker_mesh(W)``, W in {2, 4},
  the float, int8 and int32 wires, the linear probe and the reduced
  student's distill loss): on the integer wires the applied update,
  every residual and the metrics BITWISE against the one-device loop,
  and for the linear probe against the reference's sharded step on its
  ``worker_mesh(W)``; the LSTM case reaches the reference through the
  one-device loop, which ``test_torch_gtc_workers.py`` holds to it.  On
  the float wire the ranks' sum is regrouped: the update within one ulp
  of each element, the residuals bitwise.
* BMUF (``BMUFShardMap``, W = 4, tau = 2, two blocks of ``Trainer.fit``,
  then a block with an ``active`` mask): within ``BMUF_BLOCK_REL`` of each
  leaf's size a block of ``BMUFVmap`` (the sync's sum regrouped; delta
  against theta_g's size), within test_torch_bmuf's 1e-5 of the
  reference's ``BMUFShardMap``; the first block's metrics bitwise.
* ``Trainer`` under ``GTCShardMap(W=4)`` on the mesh: checkpoints every 2
  updates equal to the single-process files leaf for leaf, a run stopped
  at update 2 and resumed bitwise the uninterrupted one, then
  ``resize`` to W = 2 on the mesh, bitwise.
* ``launch/train.py --cluster 127.0.0.1:<port>,2,i --stage smbr --scale
  tiny --device cpu`` from an init-param ``ckpt_baseline``: ``ckpt_smbr``
  and the gathered final state bitwise the in-process ``stage_smbr``'s;
  the launcher's BMUF student stage (reduced widths) in the ranks within
  the BMUF bar of the in-process ``BMUFVmap`` stage.

The two spawns take ~10-25 s each on a loaded host.
"""
import argparse
import json
import math
import shutil
import sys
from pathlib import Path

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
from repro.distributed import gtc as G  # noqa: E402
from repro.launch.steps import make_loss_fn as jax_make_loss_fn  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.runtime import cluster as jcluster  # noqa: E402
from repro.runtime import env as jenv  # noqa: E402
from repro_torch.checkpoint import params_from_numpy  # noqa: E402
from repro_torch.runtime import cluster, env  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_cluster_ranks as R  # noqa: E402

BMUF_BLOCK_REL = 2e-6        # BMUF across ranks vs BMUFVmap, a block:
                             # ~16 float32 ulps of the leaf's size
REF_TOL = dict(rtol=1e-5, atol=1e-5)      # test_torch_bmuf's bar vs JAX


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}{i}/")
    elif torch.is_tensor(tree):
        yield prefix.rstrip("/"), tree


def _same(a, b, what):
    fa, fb = dict(_flat(a)), dict(_flat(b))
    assert list(fa) == list(fb), (what, sorted(set(fa) ^ set(fb)))
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, (what, k)
        np.testing.assert_array_equal(fa[k].numpy(), fb[k].numpy(),
                                      err_msg=f"{what}: {k}")


def _jflat(tree) -> dict:
    return {".".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _bmuf_gap(got: dict, ref: dict) -> float:
    """The largest leaf difference relative to the leaf's size; delta's
    against theta_g's leaf (a step of the parameters)."""
    worst = 0.0
    fr = dict(_flat(ref))
    for k, x in _flat(got):
        y = fr[k]
        if not y.is_floating_point() or y.numel() == 0:
            assert torch.equal(x, y), k
            continue
        scale = y
        if k.startswith("strategy/delta/"):
            scale = fr["params/" + k[len("strategy/delta/"):]]
        elif k.startswith("delta/"):
            scale = fr["theta_g/" + k[len("delta/"):]]
        worst = max(worst, float((x.double() - y.double()).abs().max())
                    / max(float(scale.abs().max()), 1e-30))
    return worst


# ================================================= config against the JAX

@pytest.mark.parametrize("spec,environ", [
    ("host0:1234, 4, 2", None),
    ("env", {"REPRO_COORDINATOR": "c:1", "JAX_NUM_PROCESSES": "3",
             "REPRO_PROCESS_ID": "1"}),
    ("env", {"REPRO_NUM_PROCESSES": "2", "JAX_NUM_PROCESSES": "9",
             "REPRO_COORDINATOR": "c:1", "JAX_PROCESS_ID": "1"}),
    ("env", {"JAX_COORDINATOR_ADDRESS": "h:2", "JAX_NUM_PROCESSES": "4"}),
    ("env", {}),
    ("", {"REPRO_NUM_PROCESSES": "1"})])
def test_cluster_config_parses_as_the_reference(spec, environ):
    """``from_spec`` / ``from_env``: the reference's three fields;
    ``backend`` from ``REPRO_DIST_BACKEND``."""
    got = cluster.ClusterConfig.from_spec(spec, environ=environ)
    want = jcluster.ClusterConfig.from_spec(spec, environ=environ)
    assert (got.coordinator_address, got.num_processes, got.process_id) \
        == (want.coordinator_address, want.num_processes, want.process_id)
    assert got.backend == ""
    e = dict(environ or {}, REPRO_DIST_BACKEND=" Gloo ")
    assert cluster.ClusterConfig.from_spec(spec, environ=e).backend == "gloo"


@pytest.mark.parametrize("args,match", [
    (dict(num_processes=2), "coordinator"),
    (dict(coordinator_address="c:1", num_processes=2, process_id=5),
     "process_id"),
    (dict(coordinator_address="c:1", num_processes=2, process_id=-1),
     "process_id")])
def test_cluster_config_validate_raises_as_the_reference(args, match):
    for mod in (cluster, jcluster):
        with pytest.raises(ValueError, match=match):
            mod.ClusterConfig(**args).validate()
    with pytest.raises(ValueError, match="want 'host:port"):
        cluster.ClusterConfig.from_spec("host:1,2")


def test_cluster_backend_checks():
    cluster.ClusterConfig().validate()
    with pytest.raises(ValueError, match="backend 'mpi'"):
        cluster.ClusterConfig("c:1", 2, 0, "mpi").validate()
    with pytest.raises(ValueError, match="coordinator"):
        cluster.ClusterConfig(backend="gloo").validate()
    cluster._reset_for_tests()
    try:
        # nccl refuses the host, and two ranks on one device (when CUDA
        # is absent the device rule raises first): before any group
        with pytest.raises((ValueError, RuntimeError)):
            cluster.initialize(cluster.ClusterConfig("127.0.0.1:1", 2, 0,
                                                     "nccl"), device="cpu")
        assert cluster.active() is None
        assert not torch.distributed.is_initialized()
    finally:
        cluster._reset_for_tests()


def test_initialize_single_process_noop_and_idempotent():
    cluster._reset_for_tests()
    try:
        info = cluster.initialize(cluster.ClusterConfig())
        assert info == cluster.ClusterInfo(False, 0, 1)
        assert info.is_coordinator and not info.initialized
        again = cluster.initialize(cluster.ClusterConfig("c:1", 2, 1))
        assert again is info and cluster.active() is info
        assert cluster.world_size() == 1 and cluster.is_leader()
        assert cluster.host_sum(2.5) == 2.5
        assert cluster.on_leader(lambda: 7) == 7
        assert not torch.distributed.is_initialized()
    finally:
        cluster._reset_for_tests()


def test_widest_divisor_and_topologies_match_the_reference():
    for w in range(1, 33):
        for n in range(0, 20):
            assert cluster.widest_divisor(w, n) == \
                jcluster.widest_divisor(w, n), (w, n)
    for mod in (cluster, jcluster):
        with pytest.raises(ValueError):
            mod.widest_divisor(0, 8)
        with pytest.raises(KeyError):
            mod.topology_mesh("bmuf-1024")
    assert cluster.PAPER_TOPOLOGIES == jcluster.PAPER_TOPOLOGIES
    mesh = cluster.topology_mesh("gtc-16")
    assert (mesh.n_workers, mesh.n, mesh.lanes, mesh.distributed) == \
        (16, 1, tuple(range(16)), False)


# ====================================================== env against the JAX

@pytest.mark.parametrize("environ", [
    {}, {"REPRO_PLATFORM": "CPU", "REPRO_X64": "1", "REPRO_DEBUG_NANS": "on",
         "REPRO_PREALLOCATE": "0", "REPRO_XLA_FLAGS": "--a=1 --b=2"},
    {"REPRO_HOST_DEVICES": "4", "REPRO_PLATFORM": "gpu",
     "REPRO_PREALLOCATE": "yes"}])
def test_env_config_parses_as_the_reference(environ):
    got = env.EnvConfig.from_env(environ)
    want = jenv.EnvConfig.from_env(environ)
    for f in ("host_device_count", "platform", "enable_x64", "debug_nans",
              "preallocate", "extra_xla_flags"):
        assert getattr(got, f) == getattr(want, f), f


def test_env_bootstrap_applies_what_torch_has():
    e = {"PYTORCH_CUDA_ALLOC_CONF": "max_split_size_mb:64"}
    cfg = env.bootstrap(env.EnvConfig(platform="gpu", preallocate=False),
                        environ=e)
    assert cfg.device == "cuda"
    assert e["PYTORCH_CUDA_ALLOC_CONF"] == \
        "max_split_size_mb:64,expandable_segments:True"
    env.bootstrap(env.EnvConfig(preallocate=True), environ=e)
    assert e["PYTORCH_CUDA_ALLOC_CONF"] == \
        "max_split_size_mb:64,expandable_segments:False"
    assert env.bootstrap_from_env({"REPRO_PLATFORM": "cpu"}).device == "cpu"
    assert env.EnvConfig().device == ""
    with pytest.raises(ValueError, match="--cluster"):
        env.bootstrap_from_env({"REPRO_HOST_DEVICES": "4"})
    with pytest.raises(ValueError, match="REPRO_PLATFORM='tpu'"):
        env.bootstrap(platform="tpu", environ={})
    with pytest.raises(TypeError):
        env.bootstrap(env.EnvConfig(), platform="cpu")


def test_env_describe_snapshot(tmp_path, capsys):
    snap = env.save_describe(str(tmp_path / "d" / "describe.json"))
    for key in ("torch_version", "cuda_version", "devices", "nvidia_smi",
                "process_index", "process_count", "backend", "env", "pid"):
        assert key in snap, key
    assert (snap["process_index"], snap["process_count"]) == (0, 1)
    assert json.loads((tmp_path / "d" / "describe.json").read_text()) \
        == snap
    env.main(["--platform", "cpu"])
    assert json.loads(capsys.readouterr().out)["torch_version"] == \
        torch.__version__


# ===================================== one process: the one-rank mesh

@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The reduced student's weights: the reference's init, bridged."""
    jcfg = R.student_cfg(JAX_CONFIG, JaxSegment, JaxLayerSpec)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.key(5))
    pp = params_from_numpy(jax.device_get(jp), R.student_cfg(), device="cpu")
    return jcfg, jm, jp, dict(pp)


def test_one_rank_mesh_is_the_one_device_loop(weights, tmp_path):
    """Without ``initialize``, ``worker_mesh(W)`` holds every lane: the
    strategies on it are bitwise ``mesh=None`` and ``BMUFVmap``."""
    pp = weights[3]
    mesh = cluster.worker_mesh(4)
    assert (mesh.n, mesh.world, mesh.rank, mesh.lanes, mesh.distributed) \
        == (1, 1, 0, (0, 1, 2, 3), False)
    for wire in R.WIRES:
        _same(R._cpu(R.gtc_rounds(4, wire, "probe", pp, mesh)),
              R._cpu(R.gtc_rounds(4, wire, "probe", pp, None)),
              f"probe, {wire}")
    _same(R._cpu(R.gtc_fit(pp, cluster.worker_mesh, str(tmp_path / "a"))),
          R._cpu(R.gtc_fit(pp, lambda w: None, str(tmp_path / "b"))),
          "GTCShardMap fit")
    _same(R._cpu(R.bmuf_fit(pp, cluster.worker_mesh(R.BMUF_W))),
          R._cpu(R.bmuf_fit(pp, None)), "BMUFShardMap vs BMUFVmap")


# ========================================================= two gloo ranks

@pytest.fixture(scope="module")
def ranks(weights, tmp_path_factory):
    """The rank program in 2 gloo ranks, once for the module: each
    rank's results, the in-process ones beside them."""
    out = tmp_path_factory.mktemp("ranks")
    pp = weights[3]
    torch.save(pp, out / "weights.pt")
    port = R.free_port()
    R.spawn(lambda i: [sys.executable, str(Path(R.__file__)),
                       "--port", str(port), "--world", "2", "--rank", str(i),
                       "--out", str(out)], 2, cwd=out)
    got = [torch.load(out / f"rank{i}.pt") for i in range(2)]
    return out, got


def test_ranks_hold_their_lanes(ranks):
    _, got = ranks
    assert [g["info"] for g in got] == [[0, 2, "cpu"], [1, 2, "cpu"]]
    assert got[0]["lanes"] == {1: [0], 2: [0], 3: [0, 1, 2], 4: [0, 1]}
    assert got[1]["lanes"] == {1: [], 2: [1], 3: [], 4: [2, 3]}


def _ref_probe_rounds(w, wire):
    """The reference's sharded step on its ``worker_mesh(W)`` over the
    linear probe's rounds (the capture optimizer)."""
    jcfg = G.GTCConfig(tau=R.TAU, n_workers=w, **R.WIRES[wire])
    jstep = jax.jit(G.make_sharded_gtc_train_step(
        lambda p, b: (sum(jnp.sum(p[k] * b[k]) for k in sorted(p)),
                      {"loss": sum(jnp.sum(p[k] * b[k]) for k in sorted(p))}),
        lambda p, u, o, lr: (u, o), jcfg, jcluster.worker_mesh(w)))
    params = {k: jnp.zeros(s) for k, s in R.SHAPES.items()}
    state = {"residual": {k: jnp.zeros((w,) + s)
                          for k, s in R.SHAPES.items()}}
    out = []
    for r in range(R.ROUNDS):
        bs = [R.probe_batch(1000 * w + 100 * r + i) for i in range(w)]
        upd, _, state, ms = jstep(params, None, state,
                                  {k: jnp.asarray(np.stack([b[k] for b in bs]))
                                   for k in R.SHAPES}, 0.05)
        out.append((jax.device_get(upd), jax.device_get(state["residual"]),
                    jax.device_get(ms)))
    return out


@pytest.mark.parametrize("kind", ["probe", "lstm"])
@pytest.mark.parametrize("wire", list(R.WIRES))
@pytest.mark.parametrize("w", R.GTC_W)
def test_gtc_across_ranks(ranks, weights, w, wire, kind):
    _, got = ranks
    key = f"gtc/{w}/{wire}/{kind}"
    _same(got[1][key], got[0][key], "rank 1 vs rank 0")
    loop = R._cpu(R.gtc_rounds(w, wire, kind, weights[3], None))
    for r, (a, b) in enumerate(zip(got[0][key], loop)):
        _same(a["residual"], b["residual"], f"round {r} residuals")
        _same(a["metrics"], b["metrics"], f"round {r} metrics")
        if wire != "float":
            _same(a["update"], b["update"], f"round {r} update")
            continue
        for n in b["update"]:          # the ranks' sum regrouped
            x, y = a["update"][n].numpy(), b["update"][n].numpy()
            ulp = np.spacing(np.maximum(np.abs(x), np.abs(y)))
            assert (np.abs(x - y) <= ulp).all(), (r, n)
    assert any(float(m["metrics"]["gtc_density"][0]) > 0
               for m in got[0][key])
    if kind == "probe":
        for r, (a, (ju, jr, jm)) in enumerate(
                zip(got[0][key], _ref_probe_rounds(w, wire))):
            for n in ju:
                np.testing.assert_array_equal(
                    _bits(a["residual"][n].numpy()), _bits(jr[n]),
                    err_msg=f"round {r} residual {n} vs the reference")
                if wire != "float":
                    np.testing.assert_array_equal(
                        _bits(a["update"][n].numpy()), _bits(ju[n]),
                        err_msg=f"round {r} update {n} vs the reference")
                else:
                    x = a["update"][n].numpy()
                    assert (np.abs(x - ju[n]) <= np.spacing(
                        np.maximum(np.abs(x), np.abs(ju[n])))).all()
            np.testing.assert_array_equal(a["metrics"]["loss"].numpy(),
                                          np.asarray(jm["loss"]))
            np.testing.assert_allclose(a["metrics"]["gtc_density"].numpy(),
                                       np.asarray(jm["gtc_density"]),
                                       rtol=2e-7, atol=0)


def _npz(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("name,at", [("straight", None), ("killed", 2)])
def test_gtc_fit_checkpoints_resume_and_resize_across_ranks(
        ranks, weights, tmp_path, name, at):
    """4 updates of ``GTCShardMap(W=4)`` over 2 ranks (2 lanes each),
    checkpointing every 2 (rank 0 writes the gathered state); ``killed``
    stops at update 2 and a new Trainer resumes.  The final states, the
    metrics and every checkpoint (steps 2, 4 and, after ``resize`` to
    W = 2 and 2 more updates, 6) bitwise the single-process run's."""
    out, got = ranks
    ref = R._cpu(R.gtc_fit(weights[3], lambda w: None, str(tmp_path),
                           resume_at=at))
    for r in (0, 1):
        _same(got[r][f"fit/{name}"]["w4"], ref["w4"], f"W = 4, rank {r}")
        _same(got[r][f"fit/{name}"]["w2"], ref["w2"], f"W = 2, rank {r}")
        assert got[r][f"fit/{name}"]["records"] == ref["records"]
        assert got[r][f"fit/{name}"]["workers"] == 2
    files = sorted(p.name for p in tmp_path.glob("step_*"))
    assert files == sorted(p.name for p in (out / f"ckpt_{name}").glob(
        "step_*"))
    assert [f for f in files if f.endswith(".npz")] == [
        f"step_{s:08d}.npz" for s in (2, 4, 6)]
    for f in files:
        if f.endswith(".json"):
            assert json.loads((tmp_path / f).read_text()) == json.loads(
                (out / f"ckpt_{name}" / f).read_text())
            continue
        a, b = _npz(tmp_path / f), _npz(out / f"ckpt_{name}" / f)
        assert list(a) == list(b), f
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{f}: {k}")


def test_bmuf_across_ranks(ranks, weights):
    """``BMUFShardMap`` (W = 4, tau = 2) over 2 ranks: two blocks of
    ``Trainer.fit``, then a block with lane 1 masked out, against
    ``BMUFVmap`` / ``make_bmuf_block_step`` in one process and the
    reference's ``BMUFShardMap`` / sharded block step."""
    _, got = ranks
    jcfg, jm, jp, pp = weights
    _same(got[1]["bmuf"], got[0]["bmuf"], "rank 1 vs rank 0")
    mine, loop = got[0]["bmuf"], R._cpu(R.bmuf_fit(pp, None))
    # block 1 starts from the same state: its metrics bitwise
    assert mine["records"][0] == loop["records"][0]
    gap = _bmuf_gap(mine["fit"], loop["fit"])
    assert gap <= 2 * BMUF_BLOCK_REL, gap
    masked = _bmuf_gap(mine["masked"]["block"], loop["masked"]["block"])
    assert masked <= 3 * BMUF_BLOCK_REL, masked
    assert _bmuf_gap(mine["masked"]["opt"], loop["masked"]["opt"]) <= \
        3 * BMUF_BLOCK_REL

    # the reference: BMUFShardMap on its worker_mesh(4), same weights
    cfg = jbmuf.BMUFConfig(n_workers=R.BMUF_W, block_steps=R.BMUF_TAU)
    mesh = jcluster.worker_mesh(R.BMUF_W)
    losses = {k: jax_make_loss_fn(jm, jcfg, k) for k in ("ce",
                                                          "distill_topk")}
    jtr = jtrain.Trainer(jtrain.BMUFShardMap(cfg, mesh), losses,
                         metrics=jtrain.ListSink())
    jst = jtr.fit(jtr.init_state(jp), [jtrain.TrainBatch(b, lr, k) for k, b,
                                       lr in R.bmuf_micro()], resume=False)
    pairs = [("params", jst.params), ("strategy/delta",
                                      jst.strategy_state["delta"]),
             ("strategy/workers", jst.strategy_state["workers"]),
             ("opt/mu", jst.opt_state["mu"])]
    fit = dict(_flat(mine["fit"]))
    for what, tree in pairs:
        for n, a in _jflat(tree).items():
            np.testing.assert_allclose(fit[f"{what}/{n}"].numpy(), a,
                                       **REF_TOL, err_msg=f"{what}/{n}")
    block = jbmuf.make_sharded_bmuf_block_step(
        jtrain.make_sgd_step(losses["distill_topk"]), cfg, mesh)
    group = [R.distill_batch(300 + i) for i in range(R.BMUF_W * R.BMUF_TAU)]
    jb, _, _ = block({"theta_g": jst.params, **jst.strategy_state},
                     jst.opt_state, jtrain.BMUFShardMap(cfg, mesh)
                     .stack(group), 0.04, active=jnp.asarray(R.ACTIVE))
    mb = dict(_flat(mine["masked"]["block"]))
    for key in ("theta_g", "delta", "workers"):
        for n, a in _jflat(jb[key]).items():
            np.testing.assert_allclose(mb[f"{key}/{n}"].numpy(), a,
                                       **REF_TOL, err_msg=f"{key}/{n}")


def test_bmuf_rank_without_lanes(ranks, weights):
    """W = 3 on 2 ranks: rank 0 holds the 3 lanes, rank 1 none and adds
    zeros at the sync; the masked block within the bar of the loop's."""
    _, got = ranks
    _same(got[1]["bmuf3"], got[0]["bmuf3"], "rank 1 vs rank 0")
    loop = R._cpu(R.bmuf_block3(weights[3]))
    _same(got[0]["bmuf3"]["metrics"], loop["metrics"], "metrics")
    assert _bmuf_gap(got[0]["bmuf3"]["block"], loop["block"]) <= \
        BMUF_BLOCK_REL


def test_launcher_bmuf_student_across_ranks(ranks, tmp_path):
    """``launch.train.stage_student(trainer="bmuf")`` in the ranks:
    ``BMUFShardMap`` on ``worker_mesh(4)``, rank 0 writing the targets
    and the checkpoints; the gathered final state within the BMUF bar of
    the in-process ``BMUFVmap`` stage, the results' counts equal; the
    ranks' reports."""
    out, got = ranks
    ref = R._cpu(R.student_stage(str(tmp_path)))
    mine = torch.load(out / "student" / "_ranks" / "state.pt")
    blocks = int(mine["step"])
    assert blocks == ref["state"]["step"] == 4
    assert _bmuf_gap({"params": mine["params"], "opt": mine["opt"],
                      "strategy": mine["strategy"]},
                     {"params": ref["state"]["params"],
                      "opt": ref["state"]["opt"],
                      "strategy": ref["state"]["strategy"]}) \
        <= blocks * BMUF_BLOCK_REL
    for k in ("updates", "microbatches", "updates_by_loss", "shards",
              "train_frames"):
        assert got[0]["student"]["results"][k] == ref["results"][k], k
    assert math.isfinite(got[0]["student"]["results"]["loss_last"])
    assert (out / "student" / "ckpt_student_bmuf").is_dir()
    assert not list((out / "student" / "ckpt_student_bmuf" / "state")
                    .glob("step_*"))          # finalized by rank 0
    for i in range(2):
        rep = json.loads((out / "student" / "_ranks" / f"rank{i}.json")
                         .read_text())
        assert (rep["rank"], rep["world"], rep["backend"], rep["lanes"]) \
            == (i, 2, "gloo", [2 * i, 2 * i + 1])
        assert rep["foreign_modules"] == [] and rep["device"] == "cpu"
        assert rep["split"]["block_sync"]["host_ms"] > 0
        assert rep["describe"]["process_index"] == i


# ================================================ the launcher in 2 ranks

@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """``--stage smbr --scale tiny`` in 2 gloo ranks and, meanwhile, in
    this process, from the same init-param ``ckpt_baseline``."""
    from repro_torch.core.ssl_pipeline import PipelineConfig, SSLPipeline
    out = tmp_path_factory.mktemp("launched")
    p = SSLPipeline(PipelineConfig.tiny(), out_dir=str(out / "ranks"),
                    device="cpu")
    p._ckpt("baseline").save(0, p._init_params(p.student_cfg, 0))
    shutil.copytree(out / "ranks" / "ckpt_baseline",
                    out / "one" / "ckpt_baseline")
    port = R.free_port()

    def one_process():
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            one = SSLPipeline(PipelineConfig.tiny(),
                              out_dir=str(out / "one"), device="cpu")
            return one, one.stage_smbr()
        finally:
            torch.set_num_threads(threads)

    _, (one, res) = R.spawn(
        lambda i: [sys.executable, "-m", "repro_torch.launch.train",
                   "--cluster", f"127.0.0.1:{port},2,{i}", "--stage",
                   "smbr", "--device", "cpu", "--out", str(out / "ranks")],
        2, cwd=out, during=one_process)
    return out, one, res


def test_launcher_smbr_across_ranks_is_the_stage(launched):
    out, one, res = launched
    logs = [(out / f"rank{i}.log").read_text() for i in range(2)]
    assert "[train] cluster: process 0/2 (coordinator), gloo on cpu" \
        in logs[0]
    assert "[train] cluster: process 1/2, gloo on cpu" in logs[1]
    a, b = _npz(out / "ranks" / "ckpt_smbr" / "step_00000000.npz"), \
        _npz(out / "one" / "ckpt_smbr" / "step_00000000.npz")
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    st = one.fits["smbr"].state
    full = torch.load(out / "ranks" / "_ranks" / "state.pt")
    _same({"params": full["params"], "opt": full["opt"],
           "strategy": full["strategy"]},
          R._cpu({"params": st.params, "opt": st.opt_state,
                  "strategy": st.strategy_state}), "final state")
    assert int(full["step"]) == st.step == 12
    got = json.loads((out / "ranks" / "train_smbr.json").read_text())
    assert got == json.loads(json.dumps(res))
    for i in range(2):
        rep = json.loads((out / "ranks" / "_ranks" / f"rank{i}.json")
                         .read_text())
        assert (rep["rank"], rep["lanes"], rep["n_workers"]) == (i, [i], 2)
        assert rep["launches"]["gtc_compress"] == 0     # the host's plain
        assert rep["foreign_modules"] == []
        split = rep["split"]
        assert set(split) == {"grads", "pack", "all_reduce", "unpack",
                              "wire_bytes"}
        assert split["wire_bytes"] == sum(
            v.numel() for v in st.params.values())       # int8: a byte each
        assert rep["t_main"] <= rep["t_initialized"] <= rep["t_done"]
