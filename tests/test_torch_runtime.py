"""Port parity: target generation in OS processes (``runtime/workers.py``,
``pipeline/generate.py:generate_sharded(processes=N)``,
``runtime/procs.py:child_env``) and one kernel build across processes
(``kernels/_build.py``).

Inputs are made from a seed with numpy.  Tolerances:
  * The numpy linear-probe engine: its manifest (checksums of every
    shard's bytes) bitwise equal across the port's in-process pass, its
    2-process pass, a pass whose one worker is SIGKILLed mid-range, and
    the reference's in-process pass.
  * The pipeline's teacher engine in 2 CPU worker processes against the
    reference's in-process ``stage_targets`` from the same checkpoint
    (which the reference wrote): ids equal where the reference's float32
    logits separate them by more than 1e-4, values within one bf16 ulp
    (``test_torch_pipeline.hold_targets``).
  * ``launch/train.py --stage targets --gen-procs 1`` (the reduced
    teacher in a worker process) against its in-process pass from the
    same checkpoint: ids equal, values within one bf16 ulp.
No assertion depends on wall time: every fleet runs with ``SLOW``'s
240 s wave and heartbeat timeouts, so no claim is stolen from a worker
that is only slow.  Each worker is a fresh interpreter that imports torch, so the
cases spawn as few as they need: two where two race the ledger, one where
one covers the case.
"""
import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import ssl_pipeline as jsp  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.pipeline.generate import generate_sharded as jax_generate  # noqa
from repro.runtime import workers as jworkers  # noqa: E402
from repro.store import LogitStoreV2 as JaxStore  # noqa: E402
from repro_torch.core import ssl_pipeline as sp  # noqa: E402
from repro_torch.pipeline import WorkLedger, generate_sharded  # noqa: E402
from repro_torch.runtime import procs, workers  # noqa: E402
from repro_torch.store import LogitStoreV2  # noqa: E402
from test_torch_pipeline import hold_targets  # noqa: E402

K, V = 4, 30
PROBE = "repro_torch.runtime.workers:linear_probe_engine"
PROBE_KW = {"k": K, "vocab": V, "seed": 3}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLOW = {"timeout_s": 240.0, "heartbeat_timeout_s": 240.0}


@pytest.fixture(autouse=True)
def _one_thread_workers(monkeypatch):
    """Spawned workers inherit the environment: one OpenMP thread each,
    as their engines are tiny and threads would only contend with the
    rest of the suite."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _batches(n=7, b=2, t=5, f=8, seed=0):
    rng = np.random.default_rng(seed)
    return [{"feats": rng.normal(size=(b, t, f)).astype(np.float32),
             "mask": np.ones((b, t), np.float32)} for _ in range(n)]


def _manifest(root) -> bytes:
    with open(os.path.join(str(root), "manifest.json"), "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def reference_manifest(tmp_path_factory):
    """{n_batches: the reference's in-process manifest bytes}."""
    out = {}
    for n in (7, 8):
        root = tmp_path_factory.mktemp(f"ref{n}")
        jax_generate("repro.runtime.workers:linear_probe_engine",
                     _batches(n), JaxStore(str(root), k=K, vocab=V),
                     n_workers=2, engine_kwargs=PROBE_KW)
        out[n] = _manifest(root)
    return out


# ======================================================= job files

def test_job_files_match_the_reference(tmp_path):
    batches = _batches(3)
    for mod, sub in ((workers, "p"), (jworkers, "j")):
        path = mod.save_batches(str(tmp_path / sub / "b.npz"), batches)
        back = mod.load_batches(path)
        assert len(back) == 3
        for a, b in zip(batches, back):
            assert sorted(a) == sorted(b)
            for key in a:
                np.testing.assert_array_equal(a[key], b[key])
        mod.write_job_spec(str(tmp_path / sub / "job.json"),
                           store_root="s", k=K, vocab=V, ledger_path="l",
                           wave=2, batches_npz="b.npz", engine_spec=PROBE,
                           engine_kwargs=PROBE_KW,
                           crash={"worker": 1, "after_shards": 2})
    with open(tmp_path / "p" / "job.json") as f, \
            open(tmp_path / "j" / "job.json") as g:
        assert json.load(f) == json.load(g)
    assert workers.owner_name(3, 41) == jworkers.owner_name(3, 41)


def test_linear_probe_is_the_references_and_worker_blind():
    batch = _batches(1)[0]
    v0, i0 = workers.linear_probe_engine(0, PROBE_KW).forward_topk(batch)
    v7, i7 = workers.linear_probe_engine(7, PROBE_KW).forward_topk(batch)
    jv, ji = jworkers.linear_probe_engine(0, PROBE_KW).forward_topk(batch)
    for v, i in ((v7, i7), (jv, ji)):
        assert v.tobytes() == v0.tobytes() and i.tobytes() == i0.tobytes()


def test_child_env_leads_with_the_ports_source(monkeypatch):
    monkeypatch.setenv("PYTHONPATH", "/elsewhere")
    env = procs.child_env({"X_EXTRA": "1"})
    src = os.path.join(ROOT, "src")
    assert env["PYTHONPATH"].split(os.pathsep)[:2] == [src, "/elsewhere"]
    assert env["X_EXTRA"] == "1"
    monkeypatch.setenv("PYTHONPATH", src)
    assert procs.repro_pythonpath() == src


# ======================================================= the fleet

def test_two_processes_write_the_in_process_manifest(tmp_path,
                                                     reference_manifest):
    """Two worker processes race the ledger: the manifest is bitwise the
    port's in-process one and the reference's; every worker reports the
    host and no import of jax or the reference."""
    batches = _batches(7)
    inproc = LogitStoreV2(str(tmp_path / "inproc"), k=K, vocab=V)
    generate_sharded(PROBE, batches, inproc, n_workers=2,
                     engine_kwargs=PROBE_KW)
    store = LogitStoreV2(str(tmp_path / "fleet"), k=K, vocab=V)
    rep = generate_sharded(PROBE, batches, store, n_workers=2,
                           engine_kwargs=PROBE_KW, processes=2,
                           supervisor_opts=SLOW)
    assert rep["n_written"] == 7 and rep["processes"] == 2
    assert rep["frames_written"] == 70
    assert _manifest(store.root) == _manifest(inproc.root) \
        == reference_manifest[7]
    assert store.verify() == 7 and store.gc() == []
    assert len(rep["workers"]) == 2
    assert sorted(s for w in rep["workers"] for s in w["shards"]) == \
        list(range(7))
    for w in rep["workers"]:
        assert w["foreign_modules"] == [] and "error" not in w
        assert w["device"] in (None, "cpu")     # None: it claimed nothing
        assert w["launches"] == dict.fromkeys(workers.KERNELS, 0)


def test_sigkill_mid_range_is_survived(tmp_path, reference_manifest):
    """The one worker is SIGKILLed after its first shard, holding a
    claim: the supervisor reclaims by owner, respawns (the replacement
    runs disarmed) and the wave completes with the reference's
    manifest."""
    store = LogitStoreV2(str(tmp_path / "fleet"), k=K, vocab=V)
    rep = generate_sharded(PROBE, _batches(8), store, n_workers=2,
                           engine_kwargs=PROBE_KW, processes=1,
                           crash={"worker": 0, "after_shards": 1},
                           supervisor_opts=SLOW)
    assert rep["restarts"] == 1 and rep["reclaimed"] >= 1
    exits = [e for e in rep["events"] if e["event"] == "exit"]
    assert exits[0]["returncode"] == -9 and exits[0]["stolen"] >= 1
    assert rep["n_written"] == 8
    assert _manifest(store.root) == reference_manifest[8]
    assert store.verify() == 8 and store.gc() == []
    assert WorkLedger.peek_all_done(os.path.join(store.root,
                                                 "gen_ledger.json"))
    assert len(rep["workers"]) == 1              # the killed one wrote none


def test_processes_need_a_port_engine_spec(tmp_path):
    store = LogitStoreV2(str(tmp_path / "s"), k=K, vocab=V)
    with pytest.raises(ValueError, match="module:function"):
        generate_sharded(lambda w: None, _batches(2), store, processes=2)
    for spec in ("repro.runtime.workers:linear_probe_engine", "os.path:join"):
        with pytest.raises(ValueError, match="repro_torch"):
            generate_sharded(spec, _batches(2), store, processes=2,
                             engine_kwargs=PROBE_KW)
        with pytest.raises(ValueError, match="repro_torch"):
            generate_sharded(spec, _batches(2), store,
                             engine_kwargs=PROBE_KW)
    assert not os.path.exists(os.path.join(store.root, "gen_ledger.json"))


def test_a_failing_worker_fails_the_pass_with_its_output(tmp_path):
    """A worker whose engine raises (here the teacher asked for CUDA on a
    host without it, or a missing checkpoint) exits non-zero with its
    traceback in its log; the pass raises and quotes it."""
    store = LogitStoreV2(str(tmp_path / "s"), k=K, vocab=V)
    kw = {"ckpt_dir": str(tmp_path / "none"), "k": K}
    if torch.cuda.is_available():
        want = "no checkpoints"
    else:
        want = "CUDA is not available"
    with pytest.raises(RuntimeError, match=want):
        generate_sharded("repro_torch.runtime.workers:teacher_engine",
                         _batches(2), store, processes=1, engine_kwargs=kw,
                         supervisor_opts={**SLOW, "max_restarts": 0})
    reports = [f for f in os.listdir(os.path.join(store.root, "_procs"))
               if f.endswith(".json") and f.startswith("worker")]
    with open(os.path.join(store.root, "_procs", reports[0])) as f:
        rep = json.load(f)
    assert want in rep["error"] and rep["n_written"] == 0


# ============================================ the pipeline's engines

SMALL = dict(n_labeled=8, n_unlabeled=16, n_val=4, n_layers=1,
             lstm_hidden=32, epochs_baseline=1, n_sub_epochs=1,
             labeled_every=1, chunked_until=1)


def test_pipeline_teacher_engine_in_processes_matches_the_reference(
        tmp_path):
    """The reference writes a teacher checkpoint and its targets
    in-process; the port's ``stage_targets`` with ``gen_procs=2`` reads
    the checkpoint in 2 CPU worker processes: the reference's targets."""
    jout, pout = tmp_path / "jax", tmp_path / "port"
    jpipe = jsp.SSLPipeline(jsp.PipelineConfig(**SMALL), out_dir=str(jout))
    params = jax_build_model(jpipe.teacher_cfg).init(jax.random.key(1))
    jpipe._ckpt("teacher").save(0, jax.device_get(params))
    jrep = jpipe.stage_targets()
    shutil.copytree(jout / "ckpt_teacher", pout / "ckpt_teacher")
    ppipe = sp.SSLPipeline(sp.PipelineConfig(**SMALL, gen_procs=2),
                           out_dir=str(pout), device="cpu",
                           supervisor_opts=SLOW)
    prep = ppipe.stage_targets()
    for key in ("n_shards", "n_frames", "n_workers", "wave", "resumed",
                "storage_compression_x"):
        assert prep[key] == jrep[key], key
    assert prep["processes"] == 2 and prep["restarts"] == 0
    for w in prep["workers"]:
        assert w["foreign_modules"] == []
        assert w["device"] in (None, "cpu")
    assert sum(w["n_written"] for w in prep["workers"]) == prep["n_shards"]
    hold_targets(pout / "logit_store", jout / "logit_store", jpipe)
    for factory in (sp.pipeline_teacher_engine, sp.pipeline_student_engine):
        with pytest.raises(KeyError):
            factory(0, {})


# ================================================ one build, N processes

_BUILD_ALL = textwrap.dedent('''
    import sys
    from pathlib import Path
    from repro_torch.kernels import _build
    _build.BUILD_DIR = Path(sys.argv[1])
    _build.nvcc_path = lambda: sys.argv[2]
    print(sorted(_build.build_all()))
''')

_NVCC = textwrap.dedent('''\
    #!{python}
    import sys, time
    with open({calls!r}, "a") as f:
        f.write(sys.argv[-1] + "\\n")
    time.sleep(0.3)
    out = sys.argv[sys.argv.index("-o") + 1]
    open(out, "w").close()
''')


def test_build_runs_nvcc_once_across_processes(tmp_path):
    """Three processes build one cold directory at once: each source is
    compiled once between them (the build lock, then a second look for
    each library), and every library is there."""
    from repro_torch.kernels import _build
    calls = tmp_path / "calls.txt"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_NVCC.format(python=sys.executable, calls=str(calls)))
    nvcc.chmod(0o755)
    build = tmp_path / "build"
    env = procs.child_env()
    runs = [subprocess.Popen([sys.executable, "-c", _BUILD_ALL, str(build),
                              str(nvcc)], env=env, stdout=subprocess.PIPE,
                             text=True) for _ in range(3)]
    outs = [p.communicate(timeout=240)[0] for p in runs]
    assert [p.returncode for p in runs] == [0, 0, 0]
    compiled = calls.read_text().split()
    assert sorted(compiled) == sorted(str(p) for p in
                                      _build.sources().values())
    names = sorted(_build.sources())
    assert sorted(eval(o) for o in outs) == sorted(
        [names, [], []])                        # one process built them all
    for name in names:
        assert (build / _build.lib_path(name).name).exists()


def test_launch_stage_targets_in_processes(tmp_path):
    """``launch/train.py --stage targets --gen-procs 1`` at reduced
    widths on the host: a worker process, a ``teacher_engine`` of the
    checkpoint the stage writes, against the in-process pass from the
    same checkpoint: the same shards, ids equal and values within one
    bf16 ulp.  (Two processes racing the ledger are the cases above.)"""
    from repro_torch.launch import train as launch_train
    inproc = launch_train.stage_targets(full=False, device="cpu",
                                        out=str(tmp_path), log=print)
    fleet_dir = tmp_path / "fleet"
    shutil.copytree(tmp_path / "ckpt_teacher", fleet_dir / "ckpt_teacher")
    rep = launch_train.stage_targets(full=False, device="cpu", procs=1,
                                     out=str(fleet_dir), log=print,
                                     supervisor_opts=SLOW)
    assert rep["processes"] == 1 and rep["restarts"] == 0
    assert rep["n_written"] == inproc["n_written"] == rep["n_shards"]
    assert rep["n_frames"] == inproc["n_frames"]
    assert all(w["device"] in (None, "cpu") for w in rep["workers"])
    a = LogitStoreV2(str(tmp_path / "logit_store"))
    b = LogitStoreV2(str(fleet_dir / "logit_store"))
    assert a.shards() == b.shards()
    for j in a.shards():
        (av, ai), (bv, bi) = a.read_shard(j), b.read_shard(j)
        np.testing.assert_array_equal(ai, bi)
        av, bv = np.asarray(av, np.float32), np.asarray(bv, np.float32)
        ulp = np.exp2(np.floor(np.log2(np.maximum(
            np.maximum(np.abs(av), np.abs(bv)), 1e-30))) - 7)
        assert (np.abs(av - bv) <= ulp).all()
