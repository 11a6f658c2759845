"""The port stands alone: it imports neither jax nor the reference
package, and its entry points run on the card unless asked for the host.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]

_FRESH = r'''
import sys
import numpy as np
import torch
import repro_torch
from repro_torch.configs import get_arch, reduced
from repro_torch.kernels import _build
from repro_torch.launch import serve as launch
from repro_torch.models import build_model
from repro_torch.serve import SLO_DEFAULT, StreamingEngine, StreamServer
from repro_torch.core import distill, logit_store, scheduled, teacher
from repro_torch.distributed import gtc
from repro_torch.kernels import gtc_compress, sparse_ce
from repro_torch.launch import steps
from repro_torch.launch import train as launch_train
from repro_torch.optim import schedules, sgd
from repro_torch.train import (data, metrics, state, strategies,
                               trainer)
from repro_torch.kernels import decode_attention, topk_sample
from repro_torch.models import attention, layers, transformer
from repro_torch.serve import SamplingParams, TokenServer, decode, sampling
from repro_torch.utils import threefry
from repro_torch.kernels import swa_attention
from repro_torch.launch.steps import make_prefill_step
from repro_torch import pipeline, store
from repro_torch.runtime import procs
from repro_torch.checkpoint import store as checkpoint_store
from repro_torch import data
from repro_torch.data import chunking, features, loader, synthetic
from repro_torch.distributed import bmuf
from repro_torch.pipeline import prefetch
from repro_torch.pipeline import PrefetchingSource
from repro_torch.train import BMUFVmap
from repro_torch import seqtrain
from repro_torch.seqtrain import fb, graphs, smbr
from repro_torch.train import GTCShardMap
from repro_torch.core import ssl_pipeline
import runpy
quickstart = runpy.run_path("examples/quickstart_torch.py",
                            run_name="quickstart_torch")
from repro_torch.runtime import workers
from repro_torch import runtime
assert runtime.Supervisor is workers.Supervisor
from repro_torch.runtime import cluster, env
assert runtime.worker_mesh is cluster.worker_mesh
assert runtime.EnvConfig is env.EnvConfig
from repro_torch.train import BMUFShardMap
assert cluster.worker_mesh(4).lanes == (0, 1, 2, 3)
schedule = runpy.run_path("examples/million_hour_schedule_torch.py",
                          run_name="million_hour_schedule_torch")
from repro_torch.models import whisper
from repro_torch.configs import chameleon_34b, deepseek_67b, gemma3_27b
from repro_torch.models import paging
from repro_torch.serve import paging as serve_paging
from repro_torch.serve import PagedCacheConfig, RoundTokenServer
assert serve_paging.PageAllocator is repro_torch.serve.PageAllocator
for arch in ("gemma3-27b", "deepseek-67b", "chameleon-34b"):
    assert get_arch(arch).name == arch
from repro_torch.models import moe
from repro_torch.configs import qwen3_moe_30b_a3b
assert get_arch("qwen3-moe-30b-a3b") is qwen3_moe_30b_a3b.CONFIG
assert moe.capacity(1, qwen3_moe_30b_a3b.CONFIG) == 8
streams = runpy.run_path("examples/serve_streams_torch.py",
                         run_name="serve_streams_torch")
trainers = runpy.run_path("examples/distributed_trainers_torch.py",
                          run_name="distributed_trainers_torch")
from repro_torch.pipeline.generate import generate_across_ranks
from repro_torch.runtime.workers import stage_batches
ranks = runpy.run_path("tests/torch_cluster_ranks.py",
                       run_name="torch_cluster_ranks")
assert ranks["waves_scenarios"] and ranks["elastic_fit"]

cfg = reduced(get_arch("lstm-am-7khr"))
params = build_model(cfg, device="cpu",
                     generator=torch.Generator().manual_seed(0)).state_dict()
srv = StreamServer(cfg, params, n_slots=2, chunk_frames=4, k=3,
                   tiers=SLO_DEFAULT, device="cpu")
rids = [srv.submit(np.zeros((t, cfg.feat_dim), np.float32), tier="firehose")
        for t in (10, 6)]
done = srv.drain()
assert [done[r].emissions()[0].shape for r in rids] == [(10, 3), (6, 3)]
import tempfile
with tempfile.TemporaryDirectory() as out:
    res = launch_train.stage_student(full=False, device="cpu", steps=2,
                                     out=out).results
assert res["updates"] == 2, res
with tempfile.TemporaryDirectory() as out:
    res = launch_train.stage_student(full=False, trainer="bmuf",
                                     device="cpu", steps=1, out=out).results
assert res["updates"] == 1 and res["microbatches"] == 8, res
with tempfile.TemporaryDirectory() as out:
    rep = launch_train.stage_targets(full=False, device="cpu", out=out)
    assert store.LogitStoreV2(out + "/logit_store").verify() == \
        rep["n_shards"], rep
lm_cfg = reduced(get_arch("qwen2.5-3b"))
lm_params = build_model(lm_cfg, device="cpu", generator=torch.Generator()
                        .manual_seed(0)).state_dict()
tsrv = TokenServer(lm_cfg, lm_params, decode_kernel=True, device="cpu")
rids = [tsrv.submit(np.arange(1, 5), max_new=3),
        tsrv.submit(np.arange(2, 9), max_new=2,
                    sampling=SamplingParams(0.8, top_k=20, seed=1))]
done = tsrv.drain()
assert [len(done[r].out) for r in rids] == [3, 2]
psrv = TokenServer(lm_cfg, lm_params, decode_kernel=True, device="cpu",
                   paging=PagedCacheConfig(8, 4, 32))
outs = []
for _ in range(2):
    rid = psrv.submit(np.arange(1, 12), max_new=3)
    outs.append(psrv.drain()[rid].out)
assert len(outs[0]) == 3 and outs[0] == outs[1]
assert psrv.paging_stats()["hits"] == 1 and psrv.paging_stats()["live"] == 0
rsrv = RoundTokenServer(lm_cfg, lm_params, device="cpu")
rid = rsrv.submit(np.arange(1, 5), max_new=2)
assert len(rsrv.drain()[rid].out) == 2
launch.main(["--arch", "qwen2.5-3b", "--device", "cpu", "--requests", "1",
             "--max-new", "2"])
sw_cfg = reduced(get_arch("h2o-danube-3-4b"))
sw_model = build_model(sw_cfg, device="cpu",
                       generator=torch.Generator().manual_seed(0))
logits = make_prefill_step(sw_model, sw_cfg)(
    {"tokens": np.arange(1, 13).reshape(2, 6)})
assert logits.shape == (2, 1, sw_cfg.vocab_size), logits.shape
launch.main(["--arch", "h2o-danube-3-4b", "--device", "cpu", "--requests",
             "1", "--max-new", "2"])
from repro_torch.launch import dryrun
assert dryrun.reckon(get_arch("qwen2.5-3b"))["n_params"] == 3_085_938_688
assert len(launch_train.train_llm_smoke("qwen2.5-3b", steps=1,
                                        device="cpu")) == 1
assert _build._LIBS == {}, "a CPU run loaded a kernel library"

bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad

if not torch.cuda.is_available():
    calls = [lambda: StreamServer(cfg, params),
             lambda: StreamingEngine(cfg, params),
             lambda: build_model(cfg, generator=torch.Generator()),
             lambda: launch.main(["--requests", "1"]),
             lambda: launch_train.main([]),
             lambda: launch_train.main(["--stage", "all"]),
             lambda: launch_train.main(["--stage", "student", "--full"]),
             lambda: ssl_pipeline.SSLPipeline(
                 ssl_pipeline.PipelineConfig.tiny()),
             lambda: quickstart["main"]([]),
             lambda: schedule["main"]([]),
             lambda: workers.teacher_engine(0, {"ckpt_dir": "none"}),
             lambda: launch_train.stage_student(full=False, device=None),
             lambda: launch_train.main(["--stage", "targets"]),
             lambda: launch_train.main(["--stage", "baseline"]),
             lambda: launch_train.main(["--trainer", "bmuf"]),
             lambda: launch_train.main(["--stage", "teacher"]),
             lambda: launch_train.main(["--stage", "smbr"]),
             lambda: launch_train.main(["--cluster", "127.0.0.1:1,2,0",
                                        "--stage", "smbr"]),
             lambda: cluster.initialize(cluster.ClusterConfig(
                 "127.0.0.1:1", 2, 0)),
             lambda: iter(PrefetchingSource([])),
             lambda: TokenServer(lm_cfg, lm_params),
             lambda: TokenServer(lm_cfg, lm_params,
                                 paging=PagedCacheConfig(8, 4)),
             lambda: RoundTokenServer(lm_cfg, lm_params),
             lambda: launch.main(["--arch", "qwen2.5-3b", "--requests",
                                  "1"]),
             lambda: build_model(sw_cfg, generator=torch.Generator()),
             lambda: launch.main(["--arch", "h2o-danube-3-4b",
                                  "--requests", "1"]),
             lambda: launch_train.main(["--arch", "qwen2.5-3b",
                                        "--smoke"])]
    for call in calls:
        try:
            call()
        except RuntimeError as e:
            assert "CUDA is not available" in str(e), e
        else:
            raise AssertionError("an entry point ran without CUDA")
print("PORT-STANDS-ALONE")
'''


def test_fresh_interpreter_imports_no_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _FRESH], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "PORT-STANDS-ALONE" in out.stdout


_REF_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)",
                         re.M)


@pytest.mark.parametrize("where", ["src/repro_torch", "chip_smoke.py",
                                   "examples/quickstart_torch.py",
                                   "examples/million_hour_schedule_torch.py",
                                   "examples/serve_streams_torch.py",
                                   "examples/distributed_trainers_torch.py"])
def test_sources_name_no_jax_or_reference_import(where):
    path = ROOT / where
    files = sorted(path.rglob("*.py")) if path.is_dir() else [path]
    assert files
    hits = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}" for f in files
            for m in _REF_IMPORT.finditer(f.read_text())]
    assert not hits, hits


def test_chip_smoke_refuses_without_cuda_or_repo(tmp_path):
    """Alone in a directory, or on a host without CUDA, the smoke script
    exits non-zero and prints no result line."""
    import torch
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    runs = [subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                           capture_output=True, text=True, timeout=300)]
    if not torch.cuda.is_available():
        runs.append(subprocess.run([sys.executable, "chip_smoke.py"],
                                   cwd=ROOT, capture_output=True, text=True,
                                   timeout=300))
    for out in runs:
        assert out.returncode != 0
        assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout


def test_a_spawned_worker_imports_no_jax_or_reference(tmp_path,
                                                      monkeypatch):
    """A worker the port's Supervisor spawns (a fresh interpreter, the
    numpy linear-probe engine on the host) has imported neither jax nor
    the reference when it exits: its report's ``sys.modules`` check."""
    import numpy as np
    from repro_torch.pipeline import generate_sharded
    monkeypatch.setenv("OMP_NUM_THREADS", "1")     # a tiny engine
    from repro_torch.store import LogitStoreV2
    rng = np.random.default_rng(0)
    batches = [{"feats": rng.normal(size=(2, 4, 6)).astype(np.float32),
                "mask": np.ones((2, 4), np.float32)} for _ in range(2)]
    rep = generate_sharded(
        "repro_torch.runtime.workers:linear_probe_engine", batches,
        LogitStoreV2(str(tmp_path), k=3, vocab=11), processes=1,
        engine_kwargs={"k": 3, "vocab": 11},
        supervisor_opts={"timeout_s": 240.0, "heartbeat_timeout_s": 240.0})
    [worker] = rep["workers"]
    assert worker["n_written"] == 2 and worker["device"] == "cpu"
    assert worker["foreign_modules"] == []
