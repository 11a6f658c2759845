"""The pipeline end to end against the reference's ``SSLPipeline`` on the
host, at the quickstart's config (``examples/quickstart.py``).

The port cannot reproduce JAX's threefry init, so each stage of the
port starts from the reference's own inputs and errors do not compound
across stages: one JAX pipeline runs all five stages (GTC student), and
each port stage reads what the reference left in its ``out_dir`` (the
port's checkpoints and store are the reference's files):
  baseline, teacher — from the JAX initial params (``_init_params``);
  targets           — from the JAX ``ckpt_teacher``;
  student (GTC)     — from the JAX ``ckpt_baseline`` and ``logit_store``;
  smbr              — from the JAX ``ckpt_student_gtc``.
Then a BMUF student whose groups fill, the quickstart's BMUF student
whose groups never fill (no update), and ``launch.train --stage all``
from the port's own init.

Tolerances (``close``: |got - want| <= tol * |want|, each number held
relative to its own size):
  FIRST_TOL 1e-5 — the first loss is one forward of the same params on
    the same batch (measured: equal).
  EACC_TOL 1e-4 — an expected frame accuracy (first or last, and the
    teacher's): the port's scaled forward-backward is within 2e-5 of the
    reference's gamma (ROADMAP, differences on purpose); measured here,
    the smbr stage's first eacc within 2.1e-5 relative, the others
    within 8e-7.
  LAST_TOL 1e-4 — the last loss after tens of updates.  The three-update
    parity tests (test_torch_train.py, test_torch_seqtrain.py,
    test_torch_gtc_workers.py) hold an update within 1e-4; measured here,
    every stage's last loss is equal.
  Each stage's final ``ckpt_<stage>``, leaf by leaf: the update (final -
    initial params) within LEAF_REL 1e-5 of the leaf's largest update
    plus one float32 ulp (``assert_update_close``; measured within
    2e-6), the BMUF student's within BMUF_LEAF_REL 1e-4 (block momentum
    amplifies the rounding; measured within 2.3e-5).  Under the sMBR
    stage's GTCShardMap a worker's send can flip at tau, which moves a
    value by at most FLIP = lr * tau / W per update, 1 / (1 - 0.9) times
    that through the Nesterov momentum; at most FLIP_SHARE of a leaf's
    values may differ by up to that instead (measured: 4 of 49,152
    values, each by 9.5e-7 of the bound's 5e-6).
  FERs within one frame of the validation batch (1/97: an argmax at a
    near tie may flip), and the relative FER reduction within what one
    frame of each FER moves it.
  Targets: ids equal where the reference's float32 logits separate them
    by more than 1e-4; values (stored bf16) within one bf16 ulp.
"""
import json
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import ssl_pipeline as jsp  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.store import LogitStoreV2 as JaxStore  # noqa: E402
from repro_torch.checkpoint import params_from_numpy  # noqa: E402
from repro_torch.core import ssl_pipeline as sp  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.store import LogitStoreV2  # noqa: E402
from test_torch_seqtrain import assert_update_close  # noqa: E402

# examples/quickstart.py's config
QUICKSTART = dict(n_labeled=24, n_unlabeled=48, n_val=8, epochs_baseline=2,
                  n_sub_epochs=2, labeled_every=1, chunked_until=2)
STAGES = ("baseline", "teacher", "targets", "student", "smbr")
# what each port stage reads from the reference's out_dir
INPUTS = {"baseline": (), "teacher": (), "targets": ("ckpt_teacher",),
          "student": ("ckpt_baseline", "logit_store"),
          "smbr": ("ckpt_baseline", "ckpt_student_gtc")}
FIRST_TOL = 1e-5
EACC_TOL = 1e-4
LAST_TOL = 1e-4
LEAF_REL = 1e-5
BMUF_LEAF_REL = 1e-4
FLIP_SHARE = 1e-3
# each stage's final checkpoint and the one its update starts from
# (None: the stage's initial params)
CKPTS = {"baseline": ("baseline", None), "teacher": ("teacher", None),
         "student": ("student_gtc", "baseline"),
         "smbr": ("smbr", "student_gtc")}
GAP = 1e-4
COUNTS = ("n_shards", "n_frames", "n_workers", "wave", "resumed",
          "storage_compression_x", "n_steps")


def close(got, want, tol) -> bool:
    return abs(got - want) <= tol * abs(want)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX pipeline's five stages at the quickstart config: (the
    pipeline, its out_dir, {stage: results})."""
    out = tmp_path_factory.mktemp("reference")
    pipe = jsp.SSLPipeline(jsp.PipelineConfig(**QUICKSTART), out_dir=str(out))
    return pipe, out, {s: pipe.run(s) for s in STAGES}


def port_pipeline(out, jpipe, trainer="gtc", **kw):
    """The port's pipeline on the host at the quickstart config (``kw``
    overriding it), drawing each stage's initial params from the
    reference's init."""
    pipe = sp.SSLPipeline(sp.PipelineConfig(**QUICKSTART, **kw),
                          out_dir=str(out), device="cpu",
                          student_trainer=trainer)

    def init(cfg, seed):
        jcfg = jpipe.teacher_cfg if cfg.name == "teacher" \
            else jpipe.student_cfg
        params = jax_build_model(jcfg).init(jax.random.key(seed))
        return params_from_numpy(jax.device_get(params), cfg, device="cpu")
    pipe._init_params = init
    return pipe


def val_frames(jpipe) -> float:
    return float(np.asarray(jpipe.val_batch()["mask"]).sum())


def hold_results(got: dict, want: dict, n_val: float):
    """A stage's results against the reference's, by the tolerances of
    the module docstring."""
    assert set(got) == set(want)
    for key in COUNTS:
        if key in want:
            assert got[key] == want[key], key
    for key, tol in (("loss_first", FIRST_TOL), ("loss_last", LAST_TOL),
                     ("eacc_first", EACC_TOL), ("eacc_last", EACC_TOL),
                     ("smbr_eacc", EACC_TOL)):
        if want.get(key) is not None:
            assert close(got[key], want[key], tol), (key, got, want)
    for key in ("val_fer", "baseline_fer"):
        if key in want:
            assert abs(got[key] - want[key]) <= 1 / n_val + 1e-6, key
    if "rel_fer_reduction_pct" in want:
        base = want["baseline_fer"]
        step = 100 * 2 / n_val / max(base, 1e-9)
        assert abs(got["rel_fer_reduction_pct"]
                   - want["rel_fer_reduction_pct"]) <= step + 0.01


def hold_targets(port_root, jax_root, jpipe):
    """Shard by shard: ids equal where the reference teacher's float32
    logits separate them by more than GAP, values within one bf16 ulp."""
    js, ps = JaxStore(str(jax_root)), LogitStoreV2(str(port_root))
    assert ps.shards() == js.shards()
    assert ps.verify() == len(js.shards())
    tcfg = jpipe.teacher_cfg
    model = jax_build_model(tcfg)
    params = jpipe._load_or_none("teacher", tcfg)
    batches = jpipe._batches(jpipe.rng_unlabeled, chunked=True, seed=7)
    k = jpipe.pc.topk
    for i in js.shards():
        b = batches[i]
        lens = jnp.asarray(b["mask"].sum(-1).astype(np.int32))
        h, _ = model.apply(params, jnp.asarray(b["feats"]), lens=lens)
        logits = np.asarray(model.unembed(params, h)).reshape(
            -1, tcfg.n_senones)
        jv, ji = js.read_shard(i)
        pv, pi = ps.read_shard(i)
        jv = np.asarray(jv, np.float32).reshape(-1, k)
        ji = np.asarray(ji).reshape(-1, k)
        pv = np.asarray(pv, np.float32).reshape(-1, k)
        pi = np.asarray(pi).reshape(-1, k)
        top = -np.sort(-logits, axis=1)[:, :k + 1]
        gaps = -np.diff(top, axis=1)
        sep = gaps[:, :k] > GAP
        sep[:, 1:] &= gaps[:, :k - 1] > GAP
        assert sep.mean() > 0.5
        np.testing.assert_array_equal(pi[sep], ji[sep])
        ulp = np.exp2(np.floor(np.log2(np.maximum(
            np.maximum(np.abs(pv), np.abs(jv)), 1e-30))) - 7)
        assert (np.abs(pv - jv) <= ulp).all(), i


def hold_leaves(got_dir, want_dir, before, cfg, rel, flip=0.0):
    """The final checkpoint at ``got_dir`` against the reference's at
    ``want_dir``, leaf by leaf, as updates from ``before``: each within
    ``rel`` (``assert_update_close``), or, where a GTC send may flip
    (``flip`` > 0), all but FLIP_SHARE of each leaf's values so and
    those within ``flip``."""
    got = sp.load_params(cfg, str(got_dir), "cpu")
    want = sp.load_params(cfg, str(want_dir), "cpu")
    assert got is not None and want is not None
    assert list(got) == list(want) == list(before)
    for n, w in want.items():
        g, w, b = got[n].numpy(), w.numpy(), before[n].numpy()
        if not flip:
            assert_update_close(g, w, b, rel, n)
            continue
        dg, dw = g.astype(np.float64) - b, w.astype(np.float64) - b
        off = np.abs(dg - dw) > rel * np.abs(dw).max() + np.spacing(
            np.abs(w))
        assert off.sum() <= FLIP_SHARE * off.size, (n, int(off.sum()))
        assert (np.abs(dg - dw)[off] <= flip).all(), n


@pytest.mark.parametrize("stage", STAGES)
def test_stage_matches_the_reference(stage, reference, tmp_path):
    jpipe, jout, jres = reference
    for name in INPUTS[stage]:
        shutil.copytree(jout / name, tmp_path / name)
    pipe = port_pipeline(tmp_path, jpipe)
    got = pipe.run(stage)
    hold_results(got, jres[stage], val_frames(jpipe))
    assert pipe.stats[{"student": "student_gtc"}.get(stage, stage)][
        "frames"] > 0
    if stage == "targets":
        hold_targets(tmp_path / "logit_store", jout / "logit_store", jpipe)
        return
    name, start = CKPTS[stage]
    cfg = pipe.teacher_cfg if stage == "teacher" else pipe.student_cfg
    before = (pipe._init_params(cfg, pipe.pc.seed + (stage == "teacher"))
              if start is None else
              sp.load_params(cfg, str(jout / f"ckpt_{start}"), "cpu"))
    pc = pipe.pc
    flip = (pc.smbr_lr * pc.gtc_tau / pc.gtc_workers / (1 - 0.9)
            if stage == "smbr" else 0.0)
    hold_leaves(tmp_path / f"ckpt_{name}", jout / f"ckpt_{name}", before,
                cfg, LEAF_REL, flip)


@pytest.mark.parametrize("workers,block_steps,updates", [
    (2, 1, True),       # groups of 2 microbatches: they fill
    (4, 2, False)])     # the quickstart's: groups of 8 never fill
def test_bmuf_student_matches_the_reference(workers, block_steps, updates,
                                            reference, tmp_path):
    """The BMUF student from the reference's baseline and store, in both
    packages.  At the quickstart's W = 4, tau = 2 a sub-epoch holds 4
    shards and a labeled pass 3 chunked batches, so no group of 8 fills
    and both Trainers drop every one: no update, no FER change."""
    jpipe, jout, _ = reference
    kw = dict(bmuf_workers=workers, bmuf_block_steps=block_steps)
    res = {}
    for side in ("jax", "port"):
        for name in INPUTS["student"]:
            shutil.copytree(jout / name, tmp_path / side / name)
    res["jax"] = jsp.SSLPipeline(
        jsp.PipelineConfig(**QUICKSTART, **kw), out_dir=str(tmp_path / "jax"),
        student_trainer="bmuf").stage_student()
    port = port_pipeline(tmp_path / "port", jpipe, "bmuf", **kw)
    res["port"] = port.stage_student()
    hold_results(res["port"], res["jax"], val_frames(jpipe))
    cfg = port.student_cfg
    hold_leaves(tmp_path / "port" / "ckpt_student_bmuf",
                tmp_path / "jax" / "ckpt_student_bmuf",
                sp.load_params(cfg, str(jout / "ckpt_baseline"), "cpu"), cfg,
                BMUF_LEAF_REL)
    for r in res.values():
        if updates:
            assert r["n_steps"] > 0
        else:
            assert r["n_steps"] == 0 and r["rel_fer_reduction_pct"] == 0.0
            assert r["loss_first"] is None


def test_launch_train_all_from_the_ports_init(reference, tmp_path,
                                              monkeypatch, capsys):
    """``--stage all --scale tiny`` (tiny patched to the quickstart's
    config) from the port's own init: every stage completes with the
    reference's keys; the store's counts equal the reference's (the
    corpus is bitwise); FERs in [0, 1], losses finite."""
    jpipe, _, jres = reference
    monkeypatch.setattr(sp.PipelineConfig, "tiny",
                        classmethod(lambda cls: cls(**QUICKSTART)))
    res = launch_train.main(["--stage", "all", "--scale", "tiny",
                             "--device", "cpu", "--out", str(tmp_path)])
    assert list(res) == list(STAGES)
    for s in STAGES:
        assert set(res[s]) == set(jres[s]), s
    for key in ("n_shards", "n_frames", "storage_compression_x"):
        assert res["targets"][key] == jres["targets"][key]
    assert res["student"]["n_steps"] == jres["student"]["n_steps"]
    for s in ("baseline", "teacher", "student", "smbr"):
        assert 0 <= res[s]["val_fer"] <= 1
    for s, key in (("baseline", "loss_first"), ("baseline", "loss_last"),
                   ("teacher", "loss_last"), ("student", "loss_last"),
                   ("smbr", "eacc_last")):
        assert np.isfinite(res[s][key]), (s, key)
    assert json.loads((tmp_path / "train_all.json").read_text()) == res
    printed = capsys.readouterr().out
    assert "[pipeline] smbr:" in printed and "frames/s" in printed


def test_stages_need_their_inputs_and_in_process_generation(tmp_path):
    """Targets need a trained teacher (none is written), in-process or in
    OS processes; the student a baseline; the engine factories their
    kwargs."""
    pipe = sp.SSLPipeline(sp.PipelineConfig(**QUICKSTART),
                          out_dir=str(tmp_path), device="cpu")
    for factory in (sp.pipeline_teacher_engine, sp.pipeline_student_engine):
        with pytest.raises(KeyError):
            factory(0, {})
    pipe.pc.gen_procs = 2
    with pytest.raises(FileNotFoundError, match="run stage teacher first"):
        pipe.stage_targets()
    pipe.pc.gen_procs = 0
    with pytest.raises(FileNotFoundError, match="run stage teacher first"):
        pipe.stage_targets()
    with pytest.raises(FileNotFoundError, match="run stage baseline first"):
        pipe.stage_student()
    assert not list((tmp_path / "ckpt_teacher").glob("step_*"))
