"""Port parity: the dense token LM's full-sequence forward (prefill):
``models/attention.py`` (``flash_full_attention``, ``windowed_attention``,
``attention_apply``), ``Transformer.apply`` and
``launch/steps.make_prefill_step``, against the JAX reference on the host,
plus the h2o-danube-3-4b registry entry, its weight bridge and its decode
serving.

Weights cross by checkpoint: the reference inits in JAX,
``checkpoint.convert.params_from_numpy`` unstacks each segment's stacked
leaves.  As in ``test_torch_transformer.py``, the zero-initialised biases
and norm scales are perturbed and the N(0, 1) embedding table is scaled
by 1/sqrt(d_model).  Configs: reduced h2o-danube-3-4b at two layers with
its window cut to 16 at S=48 (the banded branch), the same at its own
window 4096 (the causal branch), and reduced qwen2.5-3b at two layers
(qkv bias, full attention, GQA 2).

Bars: the attention functions within 1e-5 of max(1, |ref|); hidden
states and logits through the model within 1e-4 of max(1, |ref|) (two
layers of float32 matrix products summed in other orders).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.serve as jserve  # noqa: E402
import repro_torch.serve as pserve  # noqa: E402
from repro import configs as jax_configs  # noqa: E402
from repro.configs.base import Segment as JaxSegment  # noqa: E402
from repro.launch.steps import make_prefill_step as jax_prefill  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import params_from_numpy  # noqa: E402
from repro_torch.configs.base import EncoderConfig, Segment  # noqa: E402
from repro_torch.kernels.swa_attention import swa_attention  # noqa: E402
from repro_torch.launch import serve as port_launch  # noqa: E402
from repro_torch.launch.steps import (make_loss_fn,  # noqa: E402
                                      make_prefill_step, model_forward)
from repro_torch.models import Transformer, build_model  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.utils.trees import tree_paths  # noqa: E402

REL = 1e-5
HREL = 1e-4
DANUBE = "h2o-danube-3-4b"


def _rel(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    return float((np.abs(a - ref) / np.maximum(1.0, np.abs(ref))).max())


def _cut(cfg, seg_cls, window=None, depth=None, **kw):
    segs = tuple(seg_cls(tuple(dataclasses.replace(sp, window=window)
                               if window else sp for sp in s.pattern),
                         depth or s.repeat) for s in cfg.segments)
    return cfg.replace(segments=segs, **kw)


def _configs(arch, window=None, depth=2, **kw):
    j = jax_configs.reduced(jax_configs.get_arch(arch))
    p = configs.reduced(configs.get_arch(arch))
    return (_cut(j, JaxSegment, window, depth, **kw),
            _cut(p, Segment, window, depth, **kw))


def _nest(flat):
    tree = {}
    for path, a in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = jnp.asarray(a)
    return tree


def _pair(jcfg, pcfg, seed):
    """(reference model, reference params, port model) on the same
    weights."""
    jm = jax_build_model(jcfg)
    params = jax.device_get(jm.init(jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    flat = {}
    for path, a in tree_paths(params):
        a = np.array(a, np.float32)
        if path == "embed":
            a = a / np.sqrt(jcfg.d_model)
        elif path.endswith(("scale", "bq", "bk", "bv")):
            a = (0.1 * rng.normal(size=a.shape)).astype(np.float32)
        flat[path] = a
    pm = build_model(pcfg, device="cpu",
                     params=params_from_numpy(flat, pcfg, device="cpu"))
    return jm, _nest(flat), pm


CONFIGS = {
    "danube-banded": dict(arch=DANUBE, window=16),
    "danube-causal": dict(arch=DANUBE),
    "qwen": dict(arch="qwen2.5-3b"),
}
S = 48


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def lm(request):
    jcfg, pcfg = _configs(**CONFIGS[request.param])
    return (request.param, jcfg, pcfg) + _pair(jcfg, pcfg, 3)


def _tokens(cfg, b=2, s=S, seed=0):
    return np.random.default_rng(seed).integers(
        1, cfg.vocab_size, (b, s)).astype(np.int32)


# ------------------------------------------------------------ attention

def _qkv(b, hkv, g, sq, skv, hd, hdv, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, hkv, g, sq, hd)).astype(np.float32),
            rng.normal(size=(b, hkv, skv, hd)).astype(np.float32),
            rng.normal(size=(b, hkv, skv, hdv)).astype(np.float32))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_flash_full_attention_matches_reference(causal, softcap):
    """Chunks that pad both sequence axes, shifted positions, a v head
    dim other than hd (as MLA has)."""
    q, k, v = _qkv(2, 2, 3, 37, 45, 16, 24, 1)
    q_pos = np.arange(37, dtype=np.int32) + 8
    kv_pos = np.arange(45, dtype=np.int32)
    kw = dict(causal=causal, attn_softcap=softcap, chunk_q=16, chunk_kv=32)
    want = jax_attn.flash_full_attention(
        *(jnp.asarray(a) for a in (q, k, v, q_pos, kv_pos)), **kw)
    got = attn.flash_full_attention(
        *(torch.from_numpy(a) for a in (q, k, v, q_pos, kv_pos)), **kw)
    assert got.shape == (2, 2, 3, 37, 24)
    assert _rel(got.numpy(), want) <= REL


@pytest.mark.parametrize("q_pos0,window,chunk", [(0, 7, 16), (5, 16, 512),
                                                 (0, 40, 8)])
def test_windowed_attention_matches_reference(q_pos0, window, chunk):
    q, k, v = _qkv(2, 2, 2, 41, 41, 16, 16, 2)
    kw = dict(attn_softcap=30.0, chunk_q=chunk)
    want = jax_attn.windowed_attention(
        *(jnp.asarray(a) for a in (q, k, v)), q_pos0, window, **kw)
    got = attn.windowed_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), q_pos0, window, **kw)
    assert got.shape == (2, 2, 2, 41, 16)
    assert _rel(got.numpy(), want) <= REL


@pytest.mark.parametrize("window", [7, 48, 100])
def test_both_branches_compute_swa_attention(window):
    """The card runs one op for both of the reference's branches: the
    banded twin (window < S) and the causal one (arange positions) are
    the function of ``swa_attention_ref``."""
    b, hkv, g, s, hd = 2, 2, 2, 48, 16
    q, k, v = (torch.from_numpy(a) for a in _qkv(b, hkv, g, s, s, hd, hd, 4))
    want = swa_attention(q.reshape(b, hkv * g, s, hd), k, v,
                         min(window, s)).reshape(q.shape)
    if window < s:
        got = attn.windowed_attention(q, k, v, 0, window, chunk_q=16)
    else:
        pos = torch.arange(s)
        got = attn.flash_full_attention(q, k, v, pos, pos, chunk_q=16,
                                        chunk_kv=32)
    assert _rel(got.numpy(), want.numpy()) <= REL


def test_attention_apply_matches_reference(lm):
    _, jcfg, pcfg, _, jp, pm = lm
    spec = pcfg.segments[0].pattern[0]
    x = np.random.default_rng(5).normal(size=(2, S, pcfg.d_model)).astype(
        np.float32)
    jpos = jnp.arange(S)
    want = jax_attn.attention_apply(
        jax.tree_util.tree_map(lambda a: a[1], jp["seg0"]["p0"]["mixer"]),
        jcfg, jcfg.segments[0].pattern[0], jnp.asarray(x), jpos)
    with torch.no_grad():
        got = attn.attention_apply(pm.seg0[1]["p0"]["mixer"], pcfg, spec,
                                   torch.from_numpy(x), torch.arange(S))
    assert got.shape == (2, S, pcfg.d_model)
    assert _rel(got.numpy(), want) <= REL
    with torch.no_grad():
        by_default = attn.attention_apply(pm.seg0[1]["p0"]["mixer"], pcfg,
                                          spec, torch.from_numpy(x))
    assert torch.equal(by_default, got)


def test_attention_apply_offset_positions_on_host(lm):
    """Positions other than arange(S) (a chunk of a longer prompt) follow
    the reference on the host, where the mask is by position."""
    _, jcfg, pcfg, _, jp, pm = lm
    spec = pcfg.segments[0].pattern[0]
    x = np.random.default_rng(6).normal(size=(2, S, pcfg.d_model)).astype(
        np.float32)
    want = jax_attn.attention_apply(
        jax.tree_util.tree_map(lambda a: a[0], jp["seg0"]["p0"]["mixer"]),
        jcfg, jcfg.segments[0].pattern[0], jnp.asarray(x),
        jnp.arange(S) + 37)
    with torch.no_grad():
        got = attn.attention_apply(pm.seg0[0]["p0"]["mixer"], pcfg, spec,
                                   torch.from_numpy(x), torch.arange(S) + 37)
    assert _rel(got.numpy(), want) <= REL


# ------------------------------------------------------ model and step

def test_apply_and_prefill_match_reference(lm):
    name, jcfg, pcfg, jm, jp, pm = lm
    tok = _tokens(pcfg)
    jh, jaux = jm.apply(jp, jnp.asarray(tok))
    with torch.no_grad():
        ph, paux = pm.apply(torch.from_numpy(tok))
    assert paux == {} and ph.shape == (2, S, pcfg.d_model)
    assert _rel(ph.numpy(), jh) <= HREL
    want = jax_prefill(jm, jcfg)(jp, {"tokens": jnp.asarray(tok)})
    got = make_prefill_step(pm, pcfg)({"tokens": tok})
    assert got.shape == (2, 1, pcfg.vocab_size) and got.dtype == torch.float32
    assert got.is_inference()
    assert _rel(got.numpy(), want) <= HREL
    if name == "danube-banded":       # the whole-sequence chunk, both sides
        jc2, pc2 = (c.replace(attn_whole_seq=True) for c in (jcfg, pcfg))
        jm2 = jax_build_model(jc2)
        pm2 = build_model(pc2, device="cpu", params=pm.state_dict())
        want = jax_prefill(jm2, jc2)(jp, {"tokens": jnp.asarray(tok)})
        got = make_prefill_step(pm2, pc2)({"tokens": tok})
        assert _rel(got.numpy(), want) <= HREL


def test_model_forward_runs_own_or_given_weights(lm):
    _, _, pcfg, _, _, pm = lm
    tok = _tokens(pcfg, b=1, s=12)
    with torch.no_grad():
        h1, _ = model_forward(pm, pcfg, None, {"tokens": tok})
        sd = {k: v * 1.0 for k, v in pm.state_dict().items()}
        h2, _ = model_forward(pm, pcfg, sd, {"tokens": torch.from_numpy(tok)})
    assert torch.equal(h1, h2)


@pytest.mark.parametrize("decode_kernel", [False, True])
def test_prefill_matches_own_decode(decode_kernel):
    """Every position's logits of one full-sequence forward equal the
    per-row decode after the same tokens (float32 cache, window 16 < S:
    the ring wraps twice)."""
    _, pcfg = _configs(DANUBE, window=16)
    _, _, pm = _pair(*_configs(DANUBE, window=16), 5)
    dm = build_model(pcfg, device="cpu", params=pm.state_dict(),
                     decode_kernel=decode_kernel)
    tok = torch.from_numpy(_tokens(pcfg, b=2, s=40, seed=6))
    with torch.no_grad():
        h, _ = pm.apply(tok)
        full = pm.unembed(h)
    cache = dm.init_cache(2, 40, torch.float32, per_row=True)
    assert cache["seg0"]["p0"]["k"].shape[3] == 16
    steps = []
    for t in range(40):
        lg, cache = dm.decode_step(cache, tok[:, t:t + 1])
        steps.append(lg[:, 0])
    assert _rel(torch.stack(steps, 1).numpy(), full.numpy()) <= HREL
    last = make_prefill_step(pm, pcfg)({"tokens": tok})
    assert _rel(last[:, 0].numpy(), steps[-1].numpy()) <= HREL


def test_unported_forward_paths_raise(lm):
    _, _, pcfg, _, _, pm = lm
    tok = torch.from_numpy(_tokens(pcfg, b=1, s=8))
    with pytest.raises(NotImplementedError, match="not ported"):
        pm.apply(tok, positions=torch.arange(8))
    # the decoder-only LM takes no encoder config: whisper's forward is
    # models/whisper.py's (tests/test_torch_whisper.py)
    with pytest.raises(ValueError, match="whisper"):
        Transformer(pcfg.replace(encoder=EncoderConfig(2)), device="meta",
                    generator=None)
    with pytest.raises(NotImplementedError, match="step 10d"):
        make_loss_fn(pm, pcfg, "ce")


# ------------------------------------------------ registry and weights

def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _same_config(p, j):
    jf = _fields(j)
    for name, val in _fields(p).items():
        if name == "segments":
            assert [(s.repeat, [dataclasses.astuple(x) for x in s.pattern])
                    for s in val] == \
                [(s.repeat, [dataclasses.astuple(x) for x in s.pattern])
                 for s in jf[name]]
        elif name in ("mla", "encoder"):
            assert (val is None) == (jf[name] is None)
        else:
            assert val == jf[name], name
    # the reference's XLA cost-probe switches have no twin in the port
    assert set(jf) - set(_fields(p)) == {"scan_unroll", "remat"}


@pytest.mark.parametrize("arch", [DANUBE, "qwen2.5-3b+swa",
                                  "h2o-danube-3-4b+swa"])
@pytest.mark.parametrize("cut", [False, True])
def test_registry_entries_match_reference(arch, cut):
    p, j = configs.get_arch(arch), jax_configs.get_arch(arch)
    if cut:
        p, j = configs.reduced(p), jax_configs.reduced(j)
    _same_config(p, j)
    assert p.mixers() == j.mixers()
    rg = configs.get_arch("recurrentgemma-2b+swa")
    assert rg.mixers() == jax_configs.get_arch(
        "recurrentgemma-2b+swa").mixers()
    assert DANUBE in configs.ARCHS


def test_weight_bridge_crosses_danube():
    """The untied unembedding and the stacked segment leaves cross; at
    full width the port's parameters are the reference's, shape for
    shape (3.962 B in all)."""
    jcfg, pcfg = _configs(DANUBE)
    _, jp, pm = _pair(jcfg, pcfg, 7)
    sd = pm.state_dict()
    assert sd["out"].shape == (pcfg.d_model, pcfg.vocab_size)
    np.testing.assert_array_equal(sd["out"].numpy(), np.asarray(jp["out"]))
    for g in range(2):
        np.testing.assert_array_equal(
            sd[f"seg0.{g}.p0.mixer.wk"].numpy(),
            np.asarray(jp["seg0"]["p0"]["mixer"]["wk"][g]))
    full = configs.get_arch(DANUBE)
    like = Transformer(full, device="meta", generator=None).state_dict()
    shapes = jax.eval_shape(jax_build_model(jax_configs.get_arch(DANUBE)).init,
                            jax.random.key(0))
    want = {}
    for path, a in tree_paths(shapes):
        if path.startswith("seg0/"):
            for g in range(a.shape[0]):
                want["seg0." + str(g) + "." + path[5:].replace("/", ".")] = \
                    a.shape[1:]
        else:
            want[path.replace("/", ".")] = a.shape
    assert {k: tuple(v.shape) for k, v in like.items()} == \
        {k: tuple(v) for k, v in want.items()}
    assert sum(v.numel() for v in like.values()) == 3_961_839_360


# ---------------------------------------------------- decode serving

@pytest.mark.parametrize("decode_kernel", [False, True])
def test_danube_token_server_matches_reference(decode_kernel):
    """Reduced h2o-danube-3-4b with its window cut to 8 below max_seq 32,
    so every ring wraps: the same greedy tokens and counts as the JAX
    ``TokenServer``."""
    jcfg, pcfg = _configs(DANUBE, window=8, depth=1)
    _, jp, pm = _pair(jcfg, pcfg, 9)
    rng = np.random.default_rng(10)
    subs = [(rng.integers(1, pcfg.vocab_size, int(rng.integers(3, 14)))
             .astype(np.int32), int(rng.integers(4, 12))) for _ in range(5)]
    js = jserve.TokenServer(jcfg, jp, decode_kernel=decode_kernel, max_seq=32,
                            sync_every=4)
    ps = pserve.TokenServer(pcfg, pm.state_dict(), decode_kernel=decode_kernel,
                            max_seq=32, sync_every=4, device="cpu")
    for prompt, max_new in subs:
        js.submit(prompt, max_new=max_new)
        ps.submit(prompt, max_new=max_new)
    jd = {r: list(v.out) for r, v in js.drain().items()}
    pd = {r: list(v.out) for r, v in ps.drain().items()}
    assert pd == jd
    assert max(len(p) + m for p, m in subs) > 8
    for k in ("syncs", "steps", "active_slot_steps", "tokens_out"):
        assert ps.stats[k] == js.stats[k], k


def test_launch_serve_danube_on_host(capsys):
    port_launch.main(["--arch", DANUBE, "--device", "cpu", "--requests", "2",
                      "--max-new", "3"])
    out = capsys.readouterr().out
    assert "2 requests, 6 tokens" in out
