"""Port parity: the dense decoder LM (``models/transformer.py``,
``models/layers.py``) and the weight bridge, against the JAX reference on
the host.

Weights cross by checkpoint: the reference inits in JAX and
``checkpoint.convert.params_from_numpy`` unstacks each segment's stacked
leaves into the port's per-layer parameters.  The tests perturb the
reference's zero-initialised biases and norm scales, and scale its
N(0, 1) embedding table by 1/sqrt(d_model) as a trained model's is:
with the raw table every token's own logit is ~d_model and dwarfs the
rest, which would leave most of the arithmetic untested.

Bars, 12 teacher-forced per-row ``decode_step``s at ragged positions:
  * float32 caches, on the reduced model and a 3-layer one: logits
    within 1e-5 of max(1, |ref|), caches within 1e-5;
  * bf16 caches (the serving dtype), on the one-layer reduced model:
    every cache entry within one bf16 ulp, and the logits within 1e-5
    of max(1, |ref|) for as long as the caches agree bitwise.  The two
    packages' float32 k/v may differ in the last bit (matrix products
    summed in another order), which now and then rounds to the
    neighbouring bf16 value; such an entry moves later logits by up to
    ~1e-4, so past it they are held to 1e-3.  In a deeper model the
    flip also changes the next layers' inputs, which is why the bf16
    bars are stated on one layer.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.configs.base import Segment as JaxSegment  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro_torch.checkpoint import load_jax_npz, params_from_numpy  # noqa: E402
from repro_torch.configs import get_arch, reduced  # noqa: E402
from repro_torch.configs.base import Segment  # noqa: E402
from repro_torch.models import Transformer, build_model, layers  # noqa: E402
from repro_torch.utils.trees import tree_paths  # noqa: E402

REL = 1e-5


def _configs(depth):
    jcfg = jax_reduced(jax_get_arch("qwen2.5-3b"))
    pcfg = reduced(get_arch("qwen2.5-3b"))
    if depth > 1:
        jcfg = jcfg.replace(segments=(JaxSegment(
            jcfg.segments[0].pattern, repeat=depth),))
        pcfg = pcfg.replace(segments=(Segment(
            pcfg.segments[0].pattern, repeat=depth),))
    return jcfg, pcfg


def _reference_params(jcfg, seed):
    params = jax.device_get(jax_build_model(jcfg).init(jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    out = {}
    for path, a in tree_paths(params):
        a = np.array(a)
        if path == "embed":
            a = a / np.sqrt(jcfg.d_model)
        elif path.endswith(("scale", "bq", "bk", "bv")):
            a = (0.1 * rng.normal(size=a.shape)).astype(np.float32)
        out[path] = a.astype(np.float32)

    def nest(flat):
        tree = {}
        for path, a in flat.items():
            node = tree
            *head, last = path.split("/")
            for k in head:
                node = node.setdefault(k, {})
            node[last] = jnp.asarray(a)
        return tree
    return nest(out), out


def _pair(depth):
    jcfg, pcfg = _configs(depth)
    jp, flat = _reference_params(jcfg, depth)
    return jcfg, pcfg, jp, flat, params_from_numpy(flat, pcfg, device="cpu")


@pytest.fixture(scope="module", params=[1, 3], ids=["reduced", "3-layer"])
def pair(request):
    return _pair(request.param)


@pytest.fixture(scope="module")
def one_layer():
    return _pair(1)


def test_weight_bridge_unstacks_every_layer(pair):
    jcfg, pcfg, jp, flat, pp = pair
    like = Transformer(pcfg, device="meta", generator=None).state_dict()
    assert sorted(pp) == sorted(like)
    depth = pcfg.segments[0].repeat
    assert len([n for n in pp if n.endswith("mixer.wq")]) == depth
    for name, t in pp.items():
        assert tuple(t.shape) == tuple(like[name].shape) and \
            t.dtype == torch.float32
        parts = name.split(".")
        if parts[0] == "seg0":
            ref = flat["/".join(["seg0"] + parts[2:])][int(parts[1])]
        else:
            ref = flat["/".join(parts)]
        np.testing.assert_array_equal(t.numpy(), ref)
    assert (pcfg.n_layers, pcfg.d_model, pcfg.n_heads, pcfg.n_kv_heads,
            pcfg.resolved_head_dim, pcfg.vocab_size) == \
        (jcfg.n_layers, jcfg.d_model, jcfg.n_heads, jcfg.n_kv_heads,
         jcfg.resolved_head_dim, jcfg.vocab_size)


def test_weight_bridge_reads_save_tree_checkpoints(pair, tmp_path):
    _, pcfg, _, flat, pp = pair
    np.savez(tmp_path / "ckpt.npz", **{f"t::{k}": v for k, v in flat.items()})
    again = params_from_numpy(load_jax_npz(str(tmp_path / "ckpt")), pcfg,
                              device="cpu")
    for name in pp:
        assert torch.equal(pp[name], again[name])


def test_weight_bridge_refuses_missing_extra_and_misshapen(pair):
    _, pcfg, _, flat, _ = pair
    missing = dict(flat)
    missing.pop("seg0/p0/mixer/bk")
    with pytest.raises(KeyError, match="missing"):
        params_from_numpy(missing, pcfg, device="cpu")
    extra = dict(flat, **{"seg0/p0/mixer/q_norm": np.zeros((1, 64))})
    with pytest.raises(KeyError, match="unexpected"):
        params_from_numpy(extra, pcfg, device="cpu")
    bad = dict(flat, embed=flat["embed"][:, :-1])
    with pytest.raises(ValueError, match="shape mismatch"):
        params_from_numpy(bad, pcfg, device="cpu")


def _decode_both(pair, decode_kernel, cache_dtype, steps=12, seed=0):
    """Teacher-forced per-row decode in both packages from a ragged start;
    yields (step, ref logits, port logits, ref cache, port cache)."""
    jcfg, pcfg, jp, _, pp = pair
    jm = jax_build_model(jcfg, decode_kernel=decode_kernel)
    pm = build_model(pcfg, device="cpu", params=pp,
                     decode_kernel=decode_kernel)
    b, s = 3, 24
    jdt = jnp.float32 if cache_dtype == torch.float32 else jnp.bfloat16
    jc = jm.init_cache(b, s, jdt, per_row=True)
    pc = pm.init_cache(b, s, cache_dtype, per_row=True)
    start = np.asarray([0, 4, 9], np.int32)     # ragged rows
    jc["pos"] = jnp.asarray(start)
    pc["pos"] = torch.from_numpy(start.copy())
    step = jax.jit(jm.decode_step)
    rng = np.random.default_rng(seed)
    for t in range(steps):
        tok = rng.integers(0, pcfg.vocab_size, (b, 1)).astype(np.int32)
        jl, jc = step(jp, jc, jnp.asarray(tok))
        pl, pc = pm.decode_step(pc, torch.from_numpy(tok))
        yield t, np.asarray(jl), pl.numpy(), jc, pc


def _rel(a, ref):
    return float((np.abs(a - ref) / np.maximum(1.0, np.abs(ref))).max())


def _cache_arrays(jc, pc):
    for k in ("k", "v"):
        yield (np.asarray(jc["seg0"]["p0"][k].astype(jnp.float32)),
               pc["seg0"]["p0"][k].float().numpy())


@pytest.mark.parametrize("decode_kernel", [False, True])
def test_decode_step_f32_cache(pair, decode_kernel):
    for t, jl, pl, jc, pc in _decode_both(pair, decode_kernel,
                                          torch.float32):
        assert pl.shape == jl.shape and pl.dtype == np.float32
        assert _rel(pl, jl) <= REL, t
        for a, b in _cache_arrays(jc, pc):
            assert _rel(b, a) <= REL
        np.testing.assert_array_equal(pc["pos"].numpy(),
                                      np.asarray(jc["pos"]))


@pytest.mark.parametrize("decode_kernel", [False, True])
def test_decode_step_bf16_cache(one_layer, decode_kernel):
    same = True
    for t, jl, pl, jc, pc in _decode_both(one_layer, decode_kernel,
                                          torch.bfloat16):
        assert _rel(pl, jl) <= (REL if same else 1e-3), t
        for a, b in _cache_arrays(jc, pc):
            ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(a), 1e-30))) - 7)
            assert (np.abs(a - b) <= ulp).all()
            same &= bool((a == b).all())
        assert pc["seg0"]["p0"]["k"].dtype == torch.bfloat16


def test_lockstep_decode_matches_reference(pair):
    """The 0-d position (lockstep) cache of the reference's round engine."""
    jcfg, pcfg, jp, _, pp = pair
    jm = jax_build_model(jcfg)
    pm = build_model(pcfg, device="cpu", params=pp)
    jc = jm.init_cache(2, 8, jnp.float32)
    pc = pm.init_cache(2, 8, torch.float32)
    assert pc["pos"].shape == () and pc["pos"].dtype == torch.int32
    rng = np.random.default_rng(1)
    for _ in range(5):
        tok = rng.integers(0, pcfg.vocab_size, (2, 1)).astype(np.int32)
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok))
        pl, pc = pm.decode_step(pc, torch.from_numpy(tok))
        assert _rel(pl.numpy(), np.asarray(jl)) <= REL


def test_init_cache_layout(pair):
    _, pcfg, _, _, pp = pair
    pm = build_model(pcfg, device="cpu", params=pp)
    c = pm.init_cache(5, 16, per_row=True)
    rep = pcfg.segments[0].repeat
    assert set(c) == {"pos", "seg0"} and set(c["seg0"]) == {"p0"}
    for k in ("k", "v"):
        a = c["seg0"]["p0"][k]
        assert a.shape == (rep, 5, pcfg.n_kv_heads, 16,
                           pcfg.resolved_head_dim)
        assert a.dtype == torch.bfloat16 and a.is_contiguous()
    assert c["pos"].shape == (5,) and c["pos"].dtype == torch.int32


def test_reset_cache_rows_matches_reference(pair):
    jcfg, pcfg, jp, _, pp = pair
    jm = jax_build_model(jcfg)
    pm = build_model(pcfg, device="cpu", params=pp)
    jc = jm.init_cache(4, 8, jnp.float32, per_row=True)
    pc = pm.init_cache(4, 8, torch.float32, per_row=True)
    rng = np.random.default_rng(2)
    for _ in range(3):
        tok = rng.integers(0, pcfg.vocab_size, (4, 1)).astype(np.int32)
        _, jc = jm.decode_step(jp, jc, jnp.asarray(tok))
        _, pc = pm.decode_step(pc, torch.from_numpy(tok))
    rows = np.asarray([True, False, True, False])
    starts = np.asarray([2, 0, 5, 0], np.int32)
    for kw in ({}, {"starts": starts}):
        jr = jm.reset_cache_rows(jc, jnp.asarray(rows),
                                 **{k: jnp.asarray(v) for k, v in kw.items()})
        clone = {"pos": pc["pos"].clone(), "seg0": {"p0": {
            k: v.clone() for k, v in pc["seg0"]["p0"].items()}}}
        pr = pm.reset_cache_rows(clone, torch.from_numpy(rows),
                                 **{k: torch.from_numpy(v)
                                    for k, v in kw.items()})
        assert pr is clone
        np.testing.assert_array_equal(pr["pos"].numpy(), np.asarray(jr["pos"]))
        for a, b in _cache_arrays(jr, pr):
            assert _rel(b, a) <= REL
            np.testing.assert_array_equal(b[:, rows], a[:, rows])
        assert not pr["seg0"]["p0"]["k"][:, rows].any()
        assert torch.equal(pr["seg0"]["p0"]["k"][:, ~rows],
                           pc["seg0"]["p0"]["k"][:, ~rows])


def test_layers_match_reference():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 3, 64)).astype(np.float32)
    scale = (0.1 * rng.normal(size=(64,))).astype(np.float32)
    bias = rng.normal(size=(64,)).astype(np.float32)
    t = torch.from_numpy
    for kind, p in (("rmsnorm", {"scale": scale}),
                    ("layernorm", {"scale": scale + 1, "bias": bias})):
        j = np.asarray(jax_layers.norm_apply(
            {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), kind))
        pt = layers.norm_apply({k: t(v) for k, v in p.items()}, t(x), kind)
        np.testing.assert_allclose(pt.numpy(), j, atol=2e-6, rtol=0)
    np.testing.assert_allclose(
        layers.rms_head_norm(t(scale), t(x)).numpy(),
        np.asarray(jax_layers.rms_head_norm(jnp.asarray(scale),
                                            jnp.asarray(x))),
        atol=2e-6, rtol=0)
    for name in ("silu", "gelu"):
        np.testing.assert_allclose(
            layers.act_fn(name)(t(x)).numpy(),
            np.asarray(jax_layers.act_fn(name)(jnp.asarray(x))),
            atol=2e-6, rtol=0)
    np.testing.assert_allclose(layers.softcap(t(x * 40), 30.0).numpy(),
                               np.asarray(jax_layers.softcap(
                                   jnp.asarray(x * 40), 30.0)),
                               atol=1e-5, rtol=0)
    assert layers.softcap(t(x), 0.0) is not None
    mlp = {k: (rng.normal(size=s) / 8).astype(np.float32) for k, s in
           (("up", (64, 96)), ("gate", (64, 96)), ("down", (96, 64)))}
    np.testing.assert_allclose(
        layers.mlp_apply({k: t(v) for k, v in mlp.items()}, t(x),
                         "silu").numpy(),
        np.asarray(jax_layers.mlp_apply(
            {k: jnp.asarray(v) for k, v in mlp.items()}, jnp.asarray(x),
            "silu")), atol=1e-5, rtol=0)


def test_random_init_is_seeded_and_shaped():
    pcfg = reduced(get_arch("qwen2.5-3b"))
    a = build_model(pcfg, device="cpu",
                    generator=torch.Generator().manual_seed(4)).state_dict()
    b = build_model(pcfg, device="cpu",
                    generator=torch.Generator().manual_seed(4)).state_dict()
    for n in a:
        assert torch.equal(a[n], b[n])
    assert abs(float(a["embed"].std()) - 1.0) < 0.02
    assert abs(float(a["seg0.0.p0.mixer.wq"].std()) - 1 / 16) < 3e-3
    assert not a["seg0.0.p0.mixer.bq"].any()
    assert not a["final_norm.scale"].any()
    with pytest.raises(ValueError, match="generator"):
        build_model(pcfg, device="cpu")
    with pytest.raises(ValueError, match="generator"):
        Transformer(pcfg, device="cpu", generator=None)


def test_unported_model_parts_raise():
    pcfg = reduced(get_arch("qwen2.5-3b"))
    m = build_model(pcfg, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="not ported"):
        m.apply(torch.zeros((1, 4), dtype=torch.int32),
                positions=torch.arange(4))
    spec = pcfg.segments[0].pattern[0]
    with pytest.raises(NotImplementedError, match="not ported"):
        build_model(pcfg.replace(pos_emb="learned"), device="cpu",
                    generator=torch.Generator())
    # the recurrent mixers and the ffn-less block build (their parity is
    # tests/test_torch_recurrent.py's)
    rg = build_model(pcfg.replace(segments=(Segment((spec.__class__(
        mixer="rglru"),), 1),)), device="cpu", generator=torch.Generator())
    assert "seg0.0.p0.mixer.lam" in rg.state_dict()
    bare = build_model(pcfg.replace(segments=(Segment((spec.__class__(
        ffn="none"),), 1),)), device="cpu", generator=torch.Generator())
    assert not any(".norm2." in n or ".ffn." in n
                   for n in bare.state_dict())
    with pytest.raises(ValueError, match="no KV cache to page"):
        build_model(reduced(get_arch("lstm-am-7khr")), device="cpu",
                    generator=torch.Generator(), paging=object())
    with pytest.raises(ValueError, match="decode_kernel"):
        build_model(reduced(get_arch("lstm-am-7khr")), device="cpu",
                    generator=torch.Generator(), decode_kernel=True)


@pytest.mark.parametrize("decode_kernel", [False, True])
def test_ragged_reset_rows_match_their_solo_decode(pair, decode_kernel):
    """Row purity with per-row positions, the invariant of the
    reference's ``test_per_row_ragged_reset_matches_solo``, held in the
    port directly: row 1 is admitted mid-decode by ``reset_cache_rows``
    and fed its own stream four positions behind row 0; each row's
    logits equal its solo decode (float32 caches, within 1e-5)."""
    _, pcfg, _, _, pp = pair
    model = build_model(pcfg, device="cpu", params=pp,
                        decode_kernel=decode_kernel)
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        1, pcfg.vocab_size, (2, 10)).astype(np.int32))
    cache = model.init_cache(2, 16, torch.float32, per_row=True)
    for t in range(4):                     # row 0 runs alone (row 1 junk)
        feed = torch.stack([toks[0, t:t + 1], torch.tensor([7],
                                                           dtype=torch.int32)])
        _, cache = model.decode_step(cache, feed)
    cache = model.reset_cache_rows(cache, torch.tensor([False, True]))
    assert cache["pos"].tolist() == [4, 0]
    got = {0: [], 1: []}
    for t in range(6):                     # ragged: rows 4 positions apart
        feed = torch.stack([toks[0, 4 + t:5 + t], toks[1, t:t + 1]])
        lg, cache = model.decode_step(cache, feed)
        got[0].append(lg[0, 0])
        got[1].append(lg[1, 0])
    for row, start in ((0, 4), (1, 0)):
        solo = model.init_cache(1, 16, torch.float32, per_row=True)
        ref = []
        for t in range(start + 6):
            lg, solo = model.decode_step(solo, toks[row:row + 1, t:t + 1])
            ref.append(lg[0, 0])
        assert _rel(torch.stack(got[row]).numpy(),
                    torch.stack(ref[start:]).numpy()) <= REL


def _decode_step_tables_per_layer(model, cache, tokens):
    """``decode_step`` as it ran before the RoPE tables were hoisted: each
    layer's fused op computes the tables at ``pos`` itself."""
    from repro_torch.models import transformer
    cfg = model.cfg
    pos = cache["pos"]
    x = model.embed_tokens(tokens)
    for si, seg in enumerate(cfg.segments):
        groups = getattr(model, f"seg{si}")
        for gi in range(seg.repeat):
            for i, sp in enumerate(seg.pattern):
                c = {k: a[gi] for k, a in cache[f"seg{si}"][f"p{i}"].items()}
                x, _ = transformer.block_decode(groups[gi][f"p{i}"], cfg, sp,
                                                x, c, pos, use_kernel=True)
    x = layers.norm_apply(model.final_norm, x, cfg.norm)
    cache["pos"] = pos + 1
    return model.unembed(x), cache


@pytest.mark.parametrize("cache_dtype", [torch.bfloat16, torch.float32])
def test_decode_step_with_per_step_rope_tables_is_bitwise_per_layer(
        pair, cache_dtype):
    """Computing the RoPE tables once per step and passing them to every
    layer's fused op gives bitwise the logits and caches of computing them
    in each layer (reduced qwen2.5-3b, decode_kernel=True, ragged rows)."""
    _, pcfg, _, _, pp = pair
    model = build_model(pcfg, device="cpu", params=pp, decode_kernel=True)
    caches = [model.init_cache(3, 24, cache_dtype, per_row=True)
              for _ in range(2)]
    for c in caches:
        c["pos"] = torch.tensor([0, 4, 9], dtype=torch.int32)
    rng = np.random.default_rng(14)
    for _ in range(6):
        tok = torch.from_numpy(rng.integers(0, pcfg.vocab_size, (3, 1))
                               .astype(np.int32))
        once, caches[0] = model.decode_step(caches[0], tok)
        per_layer, caches[1] = _decode_step_tables_per_layer(
            model, caches[1], tok)
        assert torch.equal(once, per_layer)
        assert torch.equal(caches[0]["pos"], caches[1]["pos"])
        for k in ("k", "v"):
            assert torch.equal(caches[0]["seg0"]["p0"][k],
                               caches[1]["seg0"]["p0"][k])


@pytest.mark.parametrize("decode_kernel,per_row,want", [
    (True, True, 1),            # the fused route: once per step
    (False, True, None),        # the plain route: once per layer
    (True, False, None),        # lockstep positions take the plain route
])
def test_decode_step_rope_table_calls(pair, monkeypatch, decode_kernel,
                                      per_row, want):
    _, pcfg, _, _, pp = pair
    model = build_model(pcfg, device="cpu", params=pp,
                        decode_kernel=decode_kernel)
    calls = []
    tables = layers.rope_tables
    monkeypatch.setattr(layers, "rope_tables",
                        lambda *a, **kw: calls.append(1) or tables(*a, **kw))
    cache = model.init_cache(2, 8, torch.float32, per_row=per_row)
    model.decode_step(cache, torch.zeros((2, 1), dtype=torch.int32))
    n_layers = sum(seg.repeat * len(seg.pattern) for seg in pcfg.segments)
    assert len(calls) == (want or n_layers)
