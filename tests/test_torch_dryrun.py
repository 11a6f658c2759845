"""Port parity: the meta-device dry run (``launch/dryrun.py``) against
the reference's registry, shapes and parameter counts.

Counts are exact: the port's modules on ``meta`` tensors hold every
parameter the reference's ``abstract_params`` (``jax.eval_shape`` of
its init, nothing compiled) holds, at the published widths.  FLOPs are
``FlopCounterMode``'s: on ``meta`` tensors they equal the count over
the same step on real host tensors.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.models.api import abstract_params  # noqa: E402
from repro.utils.trees import param_count  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

ARCH_IDS = sorted(jax_configs.ARCHS)


@pytest.mark.parametrize("arch", ARCH_IDS + ["qwen2.5-3b+swa"])
def test_param_count_equals_reference(arch):
    rec = dryrun.reckon(configs.get_arch(arch))
    n = param_count(abstract_params(jax_configs.get_arch(arch)))
    assert rec["n_params"] == n
    assert rec["param_bytes"] == {"bfloat16": 2 * n, "float32": 4 * n}
    assert rec["adam_bytes"] == 8 * n + 4 and rec["grad_bytes"] == 4 * n
    assert rec["train_state_bytes"] == 20 * n + 4
    assert rec["update_peak_bytes"] == 28 * n + 8


def test_registry_shapes_and_supports_equal_reference():
    assert sorted(configs.ASSIGNED) == sorted(jax_configs.ASSIGNED)
    assert {k: vars(v) for k, v in configs.SHAPES.items()} == \
        {k: vars(v) for k, v in jax_configs.SHAPES.items()}
    for arch in ARCH_IDS + [a + "+swa" for a in jax_configs.ASSIGNED]:
        for shape in configs.SHAPES:
            assert configs.supports(configs.get_arch(arch),
                                    configs.get_shape(shape)) == \
                jax_configs.supports(jax_configs.get_arch(arch),
                                     jax_configs.get_shape(shape)), \
                (arch, shape)
    with pytest.raises(KeyError, match="unknown shape"):
        configs.get_shape("train_8k")


def _real_flops(cfg, shape, kind):
    """FlopCounterMode over the same step on real host tensors."""
    cfg = cfg.replace(attn_whole_seq=True)
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    b, s = shape.global_batch, shape.seq_len
    tok = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    with FlopCounterMode(display=False) as fc:
        if shape.kind == "train":
            params = {n: p.detach().requires_grad_(True)
                      for n, p in model.state_dict().items()}
            batch = {"tokens": tok}
            if kind == "ce":
                batch["labels"] = tok
            else:
                batch["topk_vals"] = rng.normal(size=(b, s, dryrun.TOPK))
                batch["topk_idx"] = rng.integers(0, cfg.vocab_size,
                                                 (b, s, dryrun.TOPK))
            loss, _ = steps.make_loss_fn(model, cfg, kind)(params, batch)
            torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
        elif shape.kind == "prefill":
            steps.make_prefill_step(model, cfg)({"tokens": tok})
        else:
            cache = model.init_cache(b, s, torch.bfloat16)
            model.decode_step(cache, torch.from_numpy(tok[:, :1]))
    return fc.get_total_flops()


@pytest.mark.parametrize("arch,kind,shape", [
    ("qwen2.5-3b", "ce", configs.ShapeConfig("t", 48, 2, "train")),
    ("qwen3-moe-30b-a3b", "distill_topk",
     configs.ShapeConfig("t", 24, 2, "train")),
    ("deepseek-v3-671b", "ce", configs.ShapeConfig("t", 16, 2, "train")),
    ("h2o-danube-3-4b", "prefill", configs.ShapeConfig("p", 40, 2,
                                                       "prefill")),
    ("qwen2.5-3b", "decode", configs.ShapeConfig("d", 32, 3, "decode")),
])
def test_meta_flops_equal_a_real_step(arch, kind, shape):
    """The count on meta tensors is the count of the step the host runs
    (MoE's capacity, MLA and MTP's block included), and not zero."""
    cfg = configs.reduced(configs.get_arch(arch))
    got = dryrun.step_flops(cfg, shape, loss_kind=kind)
    assert got["flops"] > 0 and sum(got["flops_by_op"].values()) == \
        got["flops"]
    assert got["flops"] == _real_flops(cfg, shape, kind)


def test_dryrun_writes_one_json_per_pair(tmp_path):
    """``--all --no-flops``: one JSON for each pair ``supports`` admits,
    the skipped ones reported with the reference's reason; then one pair
    with its FLOPs through the CLI."""
    recs = dryrun.main(["--all", "--no-flops", "--out", str(tmp_path)])
    want = [(a, s) for a in jax_configs.ASSIGNED for s in jax_configs.SHAPES]
    assert sorted((r["arch"], r["shape"]) for r in recs) == sorted(want)
    written = sorted(p.name for p in tmp_path.iterdir())
    ok = [r for r in recs if r["status"] == "ok"]
    assert written == sorted(f"{r['arch']}__{r['shape']}.json" for r in ok)
    for r in recs:
        jok, why = jax_configs.supports(jax_configs.get_arch(r["arch"]),
                                        jax_configs.get_shape(r["shape"]))
        assert (r["status"] == "ok") == jok and r.get("reason", "") == why
    rec = json.loads((tmp_path / "qwen2.5-3b__train_4k.json").read_text())
    assert rec["n_params"] == 3_085_938_688 and "flops" not in rec
    out = dryrun.main(["--arch", "xlstm-350m", "--shape", "decode_32k",
                       "--out", str(tmp_path)])
    assert out[0]["flops"] > 0 and out[0]["kind"] == "decode"
    skipped = dryrun.dryrun_one("xlstm-350m", "train_4k", out_dir=None,
                                verbose=False)
    assert "flops" not in skipped and "S=4096" in skipped["flops_skipped"]
