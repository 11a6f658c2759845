"""Port parity: the SSL pipeline across ranks (step 8c's rest).

``SSLPipeline`` in two gloo ranks on the host, each a fresh interpreter
running ``tests/torch_cluster_ranks.py --pipeline`` (one OpenMP thread, a
hard timeout, spawned once for the module), held to the same pipeline
run meanwhile in this process on one thread (the spawn's ``during=``
slot).  The config is the rank program's ``PIPE``, smaller than
``PipelineConfig.tiny()`` (whose ``run("all")`` alone takes ~80 s on one
host thread) with every stage and code path kept:
``PipelineConfig(n_labeled=12, n_unlabeled=24, n_val=4, batch=4,
chunk_len=16, epochs_baseline=1, n_sub_epochs=1, labeled_every=1,
chunked_until=1, smbr_epochs=1)`` with tiny's ``gen_workers=2``,
``gtc_workers=2`` and ``bmuf_workers=4``: 14 shards, the GTC student's 23
updates, the BMUF student's 2 blocks, 3 sMBR updates at W = 2.

* The GTC arm, ``run("all")`` through the launcher's ``run_pipeline``:
  ``ckpt_baseline``, ``ckpt_teacher``, the store (manifest, every shard
  and the ledger), ``ckpt_student_gtc``, ``ckpt_smbr``, ``train_all.json``
  and each rank's result dicts BITWISE the one process's.
* The BMUF arm (its student and sMBR from the GTC arm's baseline,
  teacher and targets): the student within ``BMUF_BLOCK_REL`` a block of
  ``BMUFVmap``'s, its sMBR stage's update within ``SMBR_SHARE`` of the
  one process's.
* Generation split over the ranks: both generated, their ranges disjoint
  and covering the store; every stage's real frames equal the one
  process's (summed over the ranks where lanes or ranges split).
* The ranks' reports; ``run_waves``'s own refusals in the ranks before
  any work; the launcher's ``--full`` refusals before any process group;
  ``generate_across_ranks`` alone against ``generate_sharded``;
  ``examples/distributed_trainers_torch.py`` on the host.  The waves,
  the elastic student and generation in worker processes across ranks:
  ``tests/test_torch_cluster_waves.py``.

The in-process port is held to the JAX pipeline stage by stage by
``tests/test_torch_pipeline.py`` (``test_stage_matches_the_reference``,
``test_launch_train_all_from_the_ports_init``); this file holds the ranks
to the in-process port, so the chain reaches the reference.

The spawn takes ~20 s on an idle 8-core host (the ranks and the one
process at once), the file ~25 s alone.
"""
import json
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.pipeline.generate import (  # noqa: E402
    generate_across_ranks, generate_sharded)
from repro_torch.runtime import cluster  # noqa: E402
from repro_torch.runtime.workers import linear_probe_engine  # noqa: E402
from repro_torch.store import LogitStoreV2  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_cluster_ranks as R  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BMUF_BLOCK_REL = 2e-6        # BMUF across ranks vs BMUFVmap, a block, as
                             # tests/test_torch_cluster.py holds it
SMBR_SHARE = 0.25            # the BMUF arm's sMBR stage's update (its
                             # checkpoint less the student it starts
                             # from) within this share of the one
                             # process's largest update element: an sMBR
                             # that did not run, or lost a rank's lanes
                             # or the all-reduce, is off by about all of it
GTC_CKPTS = ("ckpt_baseline", "ckpt_teacher", "ckpt_student_gtc",
             "ckpt_smbr")


@pytest.fixture(scope="module")
def arms(tmp_path_factory):
    """The rank program's pipeline in 2 gloo ranks and, meanwhile, in
    this process on one thread."""
    out = tmp_path_factory.mktemp("pipeline")
    (out / "ranks").mkdir()
    port = R.free_port()

    def one_process():
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            return R.pipeline_arms(str(out / "one"))
        finally:
            torch.set_num_threads(threads)

    _, one = R.spawn(
        lambda i: [sys.executable, str(Path(R.__file__)), "--port",
                   str(port), "--world", "2", "--rank", str(i), "--out",
                   str(out / "ranks"), "--pipeline"], 2, cwd=out,
        during=one_process)
    got = [torch.load(out / "ranks" / f"rank{i}.pt") for i in range(2)]
    return out, one, got


def _npz(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _same_ckpt(a: Path, b: Path):
    """Two ``CheckpointStore`` roots: the same steps, every leaf and the
    meta bitwise; no resume state left."""
    files = sorted(p.name for p in a.iterdir() if p.is_file())
    assert files == sorted(p.name for p in b.iterdir() if p.is_file())
    assert files and files[0] == "step_00000000.npz", files
    for f in files:
        if f.endswith(".json"):
            assert json.loads((a / f).read_text()) == json.loads(
                (b / f).read_text()), f
            continue
        x, y = _npz(a / f), _npz(b / f)
        assert list(x) == list(y), f
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=f"{f}: {k}")
    for d in (a, b):
        assert not list((d / "state").glob("step_*"))


def _params(d: Path) -> dict:
    return _npz(d / "step_00000000.npz")


def _gap(got: dict, ref: dict) -> float:
    """The largest leaf difference relative to the leaf's size."""
    return max(float(np.abs(got[k].astype(np.float64) - ref[k]).max())
               / max(float(np.abs(ref[k]).max()), 1e-30) for k in ref)


def _update_gap(got: Path, ref: Path, start: str, end: str) -> tuple:
    """A stage's update (checkpoint ``end`` less ``start``) under ``got``
    against the same under ``ref``: (the largest element of the
    difference, the largest of ``ref``'s update), every leaf at once."""
    g0, g1 = _params(got / start), _params(got / end)
    r0, r1 = _params(ref / start), _params(ref / end)
    upd = {k: r1[k].astype(np.float64) - r0[k] for k in r1}
    return (max(float(np.abs(g1[k].astype(np.float64) - g0[k] - upd[k])
                      .max()) for k in upd),
            max(float(np.abs(u).max()) for u in upd.values()))


@pytest.mark.parametrize("name", GTC_CKPTS)
def test_gtc_arm_checkpoints_are_the_one_process(arms, name):
    out, _, _ = arms
    _same_ckpt(out / "ranks" / "gtc" / name, out / "one" / "gtc" / name)


def test_gtc_arm_store_is_the_one_process(arms):
    """The manifest, every shard file and the ledger bitwise, whichever
    rank wrote which shard."""
    out, _, _ = arms
    a, b = out / "ranks" / "gtc", out / "one" / "gtc"
    assert (a / "logit_store" / "manifest.json").read_bytes() == \
        (b / "logit_store" / "manifest.json").read_bytes()
    files = sorted(p.name for p in (b / "logit_store" / "shards").iterdir())
    assert len(files) == 3 * 14
    assert sorted(p.name for p in (a / "logit_store" / "shards")
                  .iterdir()) == files
    for f in files:
        assert (a / "logit_store" / "shards" / f).read_bytes() == \
            (b / "logit_store" / "shards" / f).read_bytes(), f
    assert json.loads((a / "gen_ledger.json").read_text()) == json.loads(
        (b / "gen_ledger.json").read_text())
    assert LogitStoreV2(str(a / "logit_store")).verify() == 14


def test_gtc_arm_results_are_the_one_process(arms):
    out, one, got = arms
    want = json.loads(json.dumps(one["results"]))
    for r in (0, 1):
        mine = json.loads(json.dumps(got[r]["results"]))
        assert mine["gtc"] == want["gtc"], r
        for stage, res in want["bmuf"].items():     # BMUF: held below
            assert set(mine["bmuf"][stage]) == set(res), (r, stage)
        assert mine["bmuf"]["student"]["n_steps"] == 2
    assert json.loads((out / "ranks" / "gtc" / "train_all.json")
                      .read_text()) == want["gtc"]
    assert (out / "one" / "gtc" / "train_all.json").read_text() == \
        (out / "ranks" / "gtc" / "train_all.json").read_text()
    assert want["gtc"]["student"]["n_steps"] == 23
    assert want["bmuf"]["student"]["n_steps"] == 2


def test_generation_splits_over_the_ranks(arms):
    """Both ranks generated; their ranges are disjoint and cover the
    store's 14 shards; the frames are summed over the ranks."""
    _, one, got = arms
    mine = [g["stats"]["gtc"]["targets"] for g in got]
    assert mine[0]["ranks"] == mine[1]["ranks"]
    assert [r["ranges"] for r in mine[0]["ranks"]] == \
        [m["ranges"] for m in mine]
    shards = [i for m in mine for lo, hi in m["ranges"]
              for i in range(lo, hi)]
    assert all(m["ranges"] for m in mine)
    assert sorted(shards) == list(range(14))
    assert sum(r["frames_written"] for r in mine[0]["ranks"]) == \
        mine[0]["frames"] == one["stats"]["gtc"]["targets"]["frames"]
    assert all(m["frames_summed_over_ranks"] for m in mine)


@pytest.mark.parametrize("arm,stage,summed", [
    ("gtc", "baseline", False), ("gtc", "teacher", False),
    ("gtc", "targets", True), ("gtc", "student_gtc", False),
    ("gtc", "smbr", True), ("bmuf", "student_bmuf", True),
    ("bmuf", "smbr", True)])
def test_stage_stats_across_ranks(arms, arm, stage, summed):
    """A replicated stage's real frames are one rank's, a split one's
    summed over the ranks: either way the one process's.  Every rank
    starts the next stage from rank 0's checkpoint, 0 away from its own
    on the host; a mesh's lanes split over the ranks."""
    _, one, got = arms
    want = one["stats"][arm][stage]
    lanes = {"student_bmuf": [[0, 1], [2, 3]], "smbr": [[0], [1]]}
    for r, g in enumerate(got):
        st = g["stats"][arm][stage]
        assert st["frames"] == want["frames"] > 0
        assert st["frames_summed_over_ranks"] is summed
        assert not want["frames_summed_over_ranks"]
        assert st["diff_from_rank0"] == 0.0
        assert st["launches"] == {}          # the host's plain versions
        if stage in lanes:
            assert st["lanes"] == lanes[stage][r]


def test_bmuf_arm_within_its_bar(arms):
    """The BMUF student (``BMUFShardMap``, 2 lanes a rank) within
    ``BMUF_BLOCK_REL`` a block of the one process's ``BMUFVmap``; its
    sMBR stage's update within ``SMBR_SHARE`` of the one process's."""
    out, one, _ = arms
    blocks = one["results"]["bmuf"]["student"]["n_steps"]
    a, b = out / "ranks" / "bmuf", out / "one" / "bmuf"
    gap = _gap(_params(a / "ckpt_student_bmuf"),
               _params(b / "ckpt_student_bmuf"))
    assert gap <= BMUF_BLOCK_REL * blocks, gap
    diff, move = _update_gap(a, b, "ckpt_student_bmuf", "ckpt_smbr")
    print(f"sMBR update: one process's largest element {move:.3e}; the "
          f"ranks' off by {diff:.3e}; the student {gap:.3e} of its size")
    assert move > 0
    assert diff <= SMBR_SHARE * move, (diff, move)


def test_rank_reports(arms):
    out, _, got = arms
    for arm, stages in (("gtc", {"baseline", "teacher", "targets",
                                 "student_gtc", "smbr"}),
                        ("bmuf", {"student_bmuf", "smbr"})):
        for i in range(2):
            rep = json.loads((out / "ranks" / arm / "_ranks"
                              / f"rank{i}.json").read_text())
            assert (rep["rank"], rep["world"], rep["backend"],
                    rep["device"]) == (i, 2, "gloo", "cpu")
            assert rep["foreign_modules"] == []
            assert set(rep["stages"]) == stages
            assert rep["stages"] == json.loads(json.dumps(
                got[i]["stats"][arm]))
            assert rep["t_main"] <= rep["t_done"]
            assert "split" not in rep and not (
                out / "ranks" / arm / "_ranks" / "state.pt").exists()


def test_waves_and_the_elastic_student_refused_in_the_ranks(arms):
    """Under a fleet ``run_waves`` keeps the reference's refusals, raised
    in every rank before any work: the GTC arm names the BMUF student
    trainer, the BMUF arm at one lane the lane it would kill; no roster
    is written.  (The waves and the elastic student themselves run
    across ranks: ``tests/test_torch_cluster_waves.py``.)"""
    _, _, got = arms
    for g in got:
        assert set(g["refused"]) == {"run_waves", "lanes"}
        assert "BMUF student trainer" in g["refused"]["run_waves"]
        assert ">= 2 lanes" in g["refused"]["lanes"]
        assert not g["members_file"]


@pytest.mark.parametrize("argv,match", [
    (["--stage", "targets", "--full", "--gen-procs", "2"],
     "--full --stage targets --trainer gtc across 2"),
    (["--stage", "teacher", "--full"],
     "--full --stage teacher --trainer gtc across 2"),
    (["--stage", "baseline", "--full"],
     "--full --stage baseline --trainer gtc across 2"),
    (["--stage", "student", "--full"],
     "--full --stage student --trainer gtc across 2")])
def test_launcher_refuses_before_a_process_group(argv, match, tmp_path):
    """The ``--full`` routes other than smbr and the BMUF student raise
    before any process group, naming why: the reference's launcher has
    no ``--full``."""
    cluster._reset_for_tests()
    with pytest.raises(NotImplementedError,
                       match=match + ".*reference's launcher has no --full"):
        launch_train.main(["--cluster", "127.0.0.1:1,2,0", "--device",
                           "cpu", "--out", str(tmp_path)] + argv)
    assert cluster.active() is None
    assert not torch.distributed.is_initialized()
    assert not list(tmp_path.iterdir())


def test_generate_across_ranks_alone_is_generate_sharded(tmp_path):
    """Without a fleet the one rank claims every range: the store and
    the ledger bitwise ``generate_sharded``'s, the report's keys
    ``generate_sharded``'s plus the ranges."""
    assert cluster.broadcast_object({"a": 1}) == {"a": 1}
    rng = np.random.default_rng(3)
    batches = [{"feats": rng.normal(size=(2, 5, 6)).astype(np.float32),
                "mask": (np.arange(5)[None] < [[5], [3]]).astype(np.float32)}
               for _ in range(7)]
    reps = {}
    for name, fn in (("sharded", generate_sharded),
                     ("ranks", generate_across_ranks)):
        store = LogitStoreV2(str(tmp_path / name), k=4, vocab=11)
        reps[name] = fn(lambda w: linear_probe_engine(w, {"k": 4,
                                                         "vocab": 11}),
                        batches, store, n_workers=3,
                        ledger_path=str(tmp_path / name / "gen_ledger.json"))
        assert store.verify() == 7
    a, b = tmp_path / "sharded", tmp_path / "ranks"
    assert (a / "manifest.json").read_bytes() == \
        (b / "manifest.json").read_bytes()
    for f in sorted((a / "shards").iterdir()):
        assert f.read_bytes() == (b / "shards" / f.name).read_bytes()
    assert json.loads((a / "gen_ledger.json").read_text()) == json.loads(
        (b / "gen_ledger.json").read_text())
    got = reps["ranks"]
    assert {k: got[k] for k in reps["sharded"]
            if not k.endswith("_s")} == {
        k: v for k, v in reps["sharded"].items() if not k.endswith("_s")}
    assert got["ranges"] == [[0, 3], [3, 5], [5, 7]]
    assert got["ranks"] == [{"rank": 0, "ranges": got["ranges"],
                             "n_written": 7,
                             "frames_written": got["frames_written"]}]


def test_distributed_trainers_example_on_the_host(tmp_path, capsys):
    """``examples/distributed_trainers_torch.py`` in-process on the
    host: three finite loss curves and the GTC wire density printed."""
    ex = runpy.run_path(str(ROOT / "examples" /
                            "distributed_trainers_torch.py"),
                        run_name="distributed_trainers_torch")
    sinks = ex["main"](["--device", "cpu", "--out", str(tmp_path)])
    assert set(sinks) == {"gtc", "gtc_shardmap", "bmuf"}
    for name, sink in sinks.items():
        losses = sink.values("loss")
        assert losses and np.isfinite(losses).all(), name
    printed = capsys.readouterr().out
    assert "wire density" in printed and "1-rank mesh" in printed
    assert 0 < sinks["gtc"].last("gtc_density") <= 1
