"""Port parity: the recurrent mixers (``models/recurrent.py``: RG-LRU,
mLSTM, sLSTM), the transformer's recurrent and ffn-less blocks, and
recurrentgemma-2b and xlstm-350m served through the port's entry points,
against the JAX reference on the host.

Layer tests draw the reference's ``init_*_block`` weights and hand them
to the port as tensors.  Model tests carry ``reduced`` configs across
with ``checkpoint/convert.py``, each with its published layer pattern
whole so that every mixer runs: recurrentgemma-2b as (R, R, L) +
(R, R), its local window cut to 8; xlstm-350m as (M, M, M, S); d 256,
4 heads, V 512; the embedding scaled by 1/sqrt(d) and the norm scales
perturbed.

Bars:
  * ``_causal_conv``, ``_groupnorm``, the mLSTM and sLSTM blocks and
    their decode steps: within 1e-5 of max(1, |ref|);
  * ``rglru_scan``, a log-depth scan where the reference's is
    ``lax.associative_scan`` (another order of the same products):
    within 1e-5 of max(1, |ref|) at S 37 and 300, and the RG-LRU blocks
    the same;
  * the models: hidden, logits and prefill logits within 1e-4 of
    max(1, |ref|), per-row decode logits within 1e-5 every step; the
    port against itself: per-row and 0-d positions bitwise, decode
    against ``apply`` within 1e-4, a reset row against its solo run
    within 1e-5; greedy tokens equal to the reference's.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro_torch.serve as pserve  # noqa: E402
from repro import configs as jax_configs  # noqa: E402
from repro.configs.base import Segment as JaxSegment  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import recurrent as jrec  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import params_from_numpy  # noqa: E402
from repro_torch.configs.base import Segment  # noqa: E402
from repro_torch.launch import serve as port_launch  # noqa: E402
from repro_torch.launch.steps import make_prefill_step  # noqa: E402
from repro_torch.models import build_model, paging, recurrent  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.utils.trees import tree_paths  # noqa: E402

ARCHS = ("recurrentgemma-2b", "xlstm-350m")
REL = 1e-5
SCAN_REL = 1e-5
HREL = 1e-4
CPU = dict(device="cpu")
POL = dict(name="t", max_batch=4, bucket_multiple=16, sort_by_length=False,
           sync_every=4)
# the reference's counts, jax.eval_shape of its init at the published
# widths and depth
FULL_PARAMS = {"recurrentgemma-2b": 2_894_435_840,
               "xlstm-350m": 499_964_048}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Reduced widths: torch's intra-op threads only contend under the
    suite's parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    assert a.shape == ref.shape
    return float((np.abs(a - ref) / np.maximum(1.0, np.abs(ref))).max())


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict)
            else torch.tensor(np.asarray(v)) for k, v in tree.items()}


def _x(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(
        np.float32)


# ----------------------------------------------------------------- layers

# the reference's functions, jitted once for the module: a shape seen
# twice compiles once
_scan = jax.jit(jrec.rglru_scan)
_rglru_apply = jax.jit(jrec.rglru_block_apply, static_argnums=1)
_rglru_decode = jax.jit(jrec.rglru_block_decode, static_argnums=1)
_mlstm_apply = jax.jit(jrec.mlstm_block_apply, static_argnums=1)
_mlstm_decode = jax.jit(jrec.mlstm_block_decode, static_argnums=1)
_slstm_apply = jax.jit(jrec.slstm_block_apply, static_argnums=1)
_slstm_decode = jax.jit(jrec.slstm_block_decode, static_argnums=1)

def _layer_cfgs(arch):
    return (jax_configs.reduced(jax_configs.get_arch(arch)),
            configs.reduced(configs.get_arch(arch)))


def _block(arch, init, seed=1):
    """(reference cfg, port cfg, numpy params, torch params) of one
    reference ``init_*_block``."""
    jcfg, pcfg = _layer_cfgs(arch)
    p = jax.tree_util.tree_map(np.array, jax.device_get(
        init(jax.random.key(seed), jcfg)))
    return jcfg, pcfg, p, _torch_tree(p)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    x, kern = _x((2, 9, 24), 0), _x((4, 24), 1)
    st = _x((2, 3, 24), 2) if with_state else None
    want_y, want_s = jrec._causal_conv(
        jnp.asarray(x), jnp.asarray(kern),
        None if st is None else jnp.asarray(st, jnp.bfloat16))
    y, s = recurrent._causal_conv(
        torch.from_numpy(x), torch.from_numpy(kern),
        None if st is None else torch.from_numpy(st).bfloat16())
    assert _rel(y.numpy(), want_y) <= REL
    assert s.dtype == torch.float32 and _rel(s.numpy(), want_s) <= REL


def test_groupnorm_matches_reference():
    x, scale = _x((2, 5, 64), 3, 4.0), _x((64,), 4)
    want = jrec._groupnorm(jnp.asarray(x), jnp.asarray(scale), 4)
    got = recurrent._groupnorm(torch.from_numpy(x), torch.from_numpy(scale), 4)
    assert _rel(got.numpy(), want) <= REL


@pytest.mark.parametrize("s,with_h0", [(37, False), (300, True)])
def test_rglru_scan_matches_associative_scan(s, with_h0):
    jcfg, _, p, tp = _block("recurrentgemma-2b", jrec.init_rglru_block)
    w = jcfg.lru_width or jcfg.d_model
    x = _x((2, s, w), s, 0.5)
    h0 = _x((2, w), 5) if with_h0 else None
    want_h, want_last = _scan(
        p, jnp.asarray(x), None if h0 is None else jnp.asarray(h0))
    h, last = recurrent.rglru_scan(tp, torch.from_numpy(x),
                                   None if h0 is None else torch.from_numpy(h0))
    assert _rel(h.numpy(), want_h) <= SCAN_REL
    assert last.dtype == torch.float32
    assert _rel(last.numpy(), want_last) <= SCAN_REL


def test_rglru_block_apply_and_decode_match_reference():
    jcfg, pcfg, p, tp = _block("recurrentgemma-2b", jrec.init_rglru_block)
    x = _x((2, 11, pcfg.d_model), 6)
    want, wst = _rglru_apply(
        p, jcfg, jnp.asarray(x))
    got, st = recurrent.rglru_block_apply(tp, pcfg, torch.from_numpy(x))
    assert _rel(got.numpy(), want) <= SCAN_REL
    for k in ("h", "conv"):
        assert _rel(st[k].numpy(), wst[k]) <= SCAN_REL, k
    # a continued prefill and one decode step from that state
    x2 = _x((2, 5, pcfg.d_model), 7)
    want2, wst2 = _rglru_apply(
        p, jcfg, jnp.asarray(x2), wst)
    got2, st2 = recurrent.rglru_block_apply(tp, pcfg, torch.from_numpy(x2),
                                            st)
    assert _rel(got2.numpy(), want2) <= SCAN_REL
    x3 = _x((2, 1, pcfg.d_model), 8)
    want3, wst3 = _rglru_decode(
        p, jcfg, jnp.asarray(x3), wst2)
    got3, st3 = recurrent.rglru_block_decode(tp, pcfg, torch.from_numpy(x3),
                                             st2)
    assert _rel(got3.numpy(), want3) <= REL
    for k in ("h", "conv"):
        assert st3[k].dtype == torch.float32
        assert _rel(st3[k].numpy(), wst3[k]) <= REL, k


@pytest.mark.parametrize("s,chunk", [(128, 32), (100, 64)])
def test_mlstm_scan_matches_reference(s, chunk):
    """chunk 32 divides S = 128 (the reference's chunked scan); 64 does
    not divide 100 (its flat scan).  The port's loop is the same for
    both."""
    b, h, hd = 2, 2, 16
    q, k = _x((b, h, s, hd), 10, 0.3), _x((b, h, s, hd), 11, 0.3)
    v, gates = _x((b, h, s, hd), 12), _x((b, s, 2 * h), 13)
    want, (wC, wn, wm) = jrec.mlstm_scan(
        *map(jnp.asarray, (q, k, v, gates)), chunk=chunk)
    got, (C, n, m) = recurrent.mlstm_scan(
        *map(torch.from_numpy, (q, k, v, gates)), chunk=chunk)
    assert _rel(got.numpy(), want) <= REL
    for a, w in ((C, wC), (n, wn), (m, wm)):
        assert a.dtype == torch.float32 and _rel(a.numpy(), w) <= REL


def _state_close(got, want, rel=REL):
    assert set(got) == set(want)
    for k in want:
        assert _rel(got[k].numpy(), want[k]) <= rel, k


def test_mlstm_block_apply_and_decode_match_reference():
    jcfg, pcfg, p, tp = _block("xlstm-350m", jrec.init_mlstm_block)
    p["gn"] = _x(p["gn"].shape, 14)
    tp["gn"] = torch.from_numpy(p["gn"])
    x = _x((2, 9, pcfg.d_model), 15)
    want, wst = _mlstm_apply(p, jcfg, jnp.asarray(x))
    got, st = recurrent.mlstm_block_apply(tp, pcfg, torch.from_numpy(x))
    assert _rel(got.numpy(), want) <= REL
    _state_close(st, wst)
    x2 = _x((2, 4, pcfg.d_model), 16)
    want2, wst2 = _mlstm_apply(p, jcfg, jnp.asarray(x2), wst)
    got2, st2 = recurrent.mlstm_block_apply(tp, pcfg, torch.from_numpy(x2),
                                            st)
    assert _rel(got2.numpy(), want2) <= REL
    _state_close(st2, wst2)
    x3 = _x((2, 1, pcfg.d_model), 17)
    want3, wst3 = _mlstm_decode(
        p, jcfg, jnp.asarray(x3), wst2)
    got3, st3 = recurrent.mlstm_block_decode(tp, pcfg, torch.from_numpy(x3),
                                             st2)
    assert _rel(got3.numpy(), want3) <= REL
    _state_close(st3, wst3)


@pytest.mark.parametrize("s", [128, 5])
def test_slstm_block_apply_and_decode_match_reference(s):
    """S = 128 takes the reference's chunked (remat) branch, S = 5 its
    flat scan; then one decode step from the state."""
    jcfg, pcfg, p, tp = _block("xlstm-350m", jrec.init_slstm_block)
    p["b"] = _x(p["b"].shape, 18)
    tp["b"] = torch.from_numpy(p["b"])
    x = _x((2, s, pcfg.d_model), 19)
    want, wst = _slstm_apply(
        p, jcfg, jnp.asarray(x))
    got, st = recurrent.slstm_block_apply(tp, pcfg, torch.from_numpy(x))
    assert _rel(got.numpy(), want) <= REL
    _state_close(st, wst)
    x2 = _x((2, 1, pcfg.d_model), 20)
    want2, wst2 = _slstm_decode(
        p, jcfg, jnp.asarray(x2), wst)
    got2, st2 = recurrent.slstm_block_decode(tp, pcfg, torch.from_numpy(x2),
                                             st)
    assert _rel(got2.numpy(), want2) <= REL
    _state_close(st2, wst2)


# ----------------------------------------------------------------- models

def _whole_patterns(cfg, seg_cls):
    """``cfg`` reduced with its published segments' patterns whole, one
    group each, windows cut to 8."""
    return tuple(seg_cls(tuple(dataclasses.replace(sp, window=8)
                               if sp.window else sp for sp in s.pattern), 1)
                 for s in cfg.segments)


def _model_cfgs(arch):
    jfull, pfull = jax_configs.get_arch(arch), configs.get_arch(arch)
    return (jax_configs.reduced(jfull).replace(
                segments=_whole_patterns(jfull, JaxSegment)),
            configs.reduced(pfull).replace(
                segments=_whole_patterns(pfull, Segment)))


def _nest(flat):
    tree = {}
    for path, a in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = jnp.asarray(a)
    return tree


@pytest.fixture(scope="module", params=ARCHS)
def lm(request):
    """One reduced model in both packages on the same weights: the
    port's config ``pcfg``, the reference's model, params, jitted
    ``decode_step`` and flat tree (``jm``, ``jp``, ``step``, ``flat``),
    the port's params and model (``pp``, ``pm``).  The weights are the
    port's random init restacked into the reference's tree (its init
    takes seconds to compile); the bridge test holds that tree to
    ``jax.eval_shape`` of the reference's ``init``."""
    arch = request.param
    jcfg, pcfg = _model_cfgs(arch)
    jm = jax_build_model(jcfg)
    sd = build_model(pcfg, generator=torch.Generator().manual_seed(3),
                     **CPU).state_dict()
    stacks = {}
    for name, t in sd.items():
        head, *rest = name.split(".")
        if head.startswith("seg"):
            stacks.setdefault("/".join([head] + rest[1:]), []).append(t)
        else:
            stacks["/".join([head] + rest)] = [t]
    rng = np.random.default_rng(3)
    flat = {}
    for path, ts in stacks.items():
        a = torch.stack(ts).numpy() if path.startswith("seg") \
            else ts[0].numpy()
        if path == "embed":
            a = a / np.sqrt(jcfg.d_model)
        elif path.endswith("scale"):
            a = (0.1 * rng.normal(size=a.shape)).astype(np.float32)
        flat[path] = a
    pp = params_from_numpy(flat, pcfg, **CPU)
    return SimpleNamespace(arch=arch, pcfg=pcfg, jm=jm,
                           jp=_nest(flat), step=jax.jit(jm.decode_step),
                           flat=flat, pp=pp,
                           pm=build_model(pcfg, params=pp, **CPU))


def _tokens(cfg, b=2, s=24, seed=0):
    return np.random.default_rng(seed).integers(
        1, cfg.vocab_size, (b, s)).astype(np.int32)


def test_registry_resolves_every_reference_arch():
    """Every reference arch id and its ``+swa`` variant resolves, with the
    reference's fields; both new archs build on ``meta`` at the published
    widths with the reference's parameter count; an unknown id raises."""
    for name in jax_configs.ARCHS:
        for arch in (name, name + "+swa"):
            p, j = configs.get_arch(arch), jax_configs.get_arch(arch)
            assert p.name == j.name and p.mixers() == j.mixers()
            for f in dataclasses.fields(p):
                if f.name not in ("segments", "mla", "encoder"):
                    assert getattr(p, f.name) == getattr(j, f.name), \
                        (arch, f.name)
            for cut in (p, configs.reduced(p)):
                jc = j if cut is p else jax_configs.reduced(j)
                assert [(s.repeat, [dataclasses.astuple(x)
                                    for x in s.pattern])
                        for s in cut.segments] == \
                    [(s.repeat, [dataclasses.astuple(x) for x in s.pattern])
                     for s in jc.segments]
                assert cut.lru_width == jc.lru_width
    assert not hasattr(configs, "NOT_PORTED")
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_arch("no-such-arch+swa")
    for arch in ARCHS:
        m = Transformer(configs.get_arch(arch), device="meta",
                        generator=None)
        assert sum(p.numel() for p in m.parameters()) == FULL_PARAMS[arch]
        assert not paging.prefix_sharing_supported(configs.get_arch(arch))
    sd = Transformer(configs.get_arch("xlstm-350m"), device="meta",
                     generator=None).state_dict()
    assert tuple(sd["seg0.5.p3.mixer.rh"].shape) == (4, 256, 1024)
    assert tuple(sd["seg0.0.p3.mixer.mlp.up"].shape) == (1024, 1365)
    assert not any(".norm2." in n or ".ffn." in n for n in sd)


def test_weight_bridge_carries_every_leaf(lm):
    """The reference's tree (every path and shape of ``jax.eval_shape``
    of its ``init``) crosses with no missing or extra leaf
    (``params_from_numpy`` raises on either): ``lam``, ``conv``,
    ``b_if``, ``gn``, sLSTM's 3-D ``rh`` (4-D stacked) and the MLP
    inside its mixer included; every port tensor restacks to the
    reference's array, and an ffn-less block has no ``norm2`` or
    ``ffn``."""
    flat = lm.flat
    want = {p: tuple(a.shape) for p, a in tree_paths(
        jax.eval_shape(lm.jm.init, jax.random.key(0)))}
    assert {p: a.shape for p, a in flat.items()} == want
    sd = lm.pm.state_dict()
    assert set(sd) == set(lm.pp)
    for path, a in flat.items():
        head = path.split("/")[0]
        if head.startswith("seg"):
            name = path[len(head) + 1:].replace("/", ".")
            back = np.stack([sd[f"{head}.{g}.{name}"].numpy()
                             for g in range(a.shape[0])])
        else:
            back = sd[path.replace("/", ".")].numpy()
        np.testing.assert_array_equal(back, a, err_msg=path)
    names = {p.split("/", 1)[1] for p in flat if p.startswith("seg")}
    if lm.arch == "xlstm-350m":
        assert {"p0/mixer/b_if", "p0/mixer/gn", "p3/mixer/rh",
                "p3/mixer/mlp/gate"} <= names
        assert flat["seg0/p3/mixer/rh"].ndim == 4
        assert not any("norm2" in n or "/ffn/" in n for n in names)
    else:
        assert {"p0/mixer/lam", "p0/mixer/conv", "p2/mixer/wq",
                "p2/ffn/gate"} <= names


def test_apply_and_prefill_match_reference(lm):
    jm, jp, pcfg, pm = lm.jm, lm.jp, lm.pcfg, lm.pm
    tok = _tokens(pcfg)
    jh, _ = jax.jit(jm.apply)(jp, jnp.asarray(tok))
    # the reference's make_prefill_step: the last position's unembedding
    want = jm.unembed(jp, jh[:, -1:])
    with torch.no_grad():
        ph, aux = pm.apply(torch.from_numpy(tok))
        logits = pm.unembed(ph)
    assert aux == {}
    assert _rel(ph.numpy(), jh) <= HREL
    assert _rel(logits.numpy(), jm.unembed(jp, jh)) <= HREL
    got = make_prefill_step(pm, pcfg)({"tokens": tok})
    assert got.shape == (2, 1, pcfg.vocab_size) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= HREL


def test_decode_matches_reference_apply_and_lockstep(lm):
    """8 teacher-forced per-row steps from ragged positions, float32
    caches: logits within 1e-5 of the reference's each step, on the
    plain route and the fused one; the port's 0-d (lockstep) cache gives
    the per-row logits bitwise; from position 0 the decode logits are
    ``apply``'s within 1e-4."""
    pcfg, pp, pm = lm.pcfg, lm.pp, lm.pm
    toks = _tokens(pcfg, b=2, s=8, seed=2)
    jc = lm.jm.init_cache(2, 16, jnp.float32, per_row=True)
    jc["pos"] = jnp.asarray([0, 3], jnp.int32)
    want = []
    for t in range(toks.shape[1]):
        lg, jc = lm.step(lm.jp, jc, jnp.asarray(toks[:, t:t + 1]))
        want.append(np.asarray(lg))
    for decode_kernel in (False, True):
        m = build_model(pcfg, params=pp, decode_kernel=decode_kernel, **CPU)
        pc = m.init_cache(2, 16, torch.float32, per_row=True)
        pc["pos"] = torch.tensor([0, 3], dtype=torch.int32)
        for t in range(toks.shape[1]):
            got, pc = m.decode_step(pc, torch.from_numpy(toks[:, t:t + 1]))
            assert _rel(got.numpy(), want[t]) <= REL, (decode_kernel, t)
    lock = pm.init_cache(2, 16, torch.float32)
    rows = pm.init_cache(2, 16, torch.float32, per_row=True)
    steps = []
    for t in range(toks.shape[1]):
        a, lock = pm.decode_step(lock, torch.from_numpy(toks[:, t:t + 1]))
        b, rows = pm.decode_step(rows, torch.from_numpy(toks[:, t:t + 1]))
        assert torch.equal(a, b), t
        steps.append(b[:, 0])
    with torch.no_grad():
        full = pm.unembed(pm.apply(torch.from_numpy(toks))[0])
    assert _rel(torch.stack(steps, 1).numpy(), full.numpy()) <= HREL


@pytest.mark.parametrize("paged", [False, True])
def test_ragged_reset_row_matches_its_solo_decode(lm, paged):
    """Row 1 is admitted mid-decode by ``reset_cache_rows`` (its
    recurrent state and conv tail zeroed) and fed its own stream four
    positions behind row 0; each row's logits equal its solo decode
    within 1e-5, with a contiguous cache and a paged one (where the
    recurrent state stays per row, never a pool)."""
    pcfg = lm.pcfg
    kw = dict(paging=paging.PagedCacheConfig(page_size=4, n_pages=8,
                                             max_ctx=16)) if paged else {}
    model = build_model(pcfg, params=lm.pp, decode_kernel=True, **kw, **CPU)
    toks = torch.from_numpy(_tokens(pcfg, b=2, s=10, seed=6))

    def cache(b):
        c = model.init_cache(b, 16, torch.float32, per_row=True)
        if paged:
            c["pages"]["tables"][:] = torch.arange(
                1, 4 * b + 1, dtype=torch.int32).reshape(b, 4)
            c["pages"]["caps"][:] = 16
        return c
    c = cache(2)
    for t in range(4):                     # row 0 runs alone (row 1 junk)
        feed = torch.stack([toks[0, t:t + 1],
                            torch.tensor([7], dtype=torch.int32)])
        _, c = model.decode_step(c, feed)
    c = model.reset_cache_rows(c, torch.tensor([False, True]))
    assert c["pos"].tolist() == [4, 0]
    for group in (g for k, g in c.items() if k.startswith("seg")):
        for leaves in group.values():
            if "k" not in leaves:
                assert all(not a[:, 1].any() for a in leaves.values())
    got = {0: [], 1: []}
    for t in range(6):
        feed = torch.stack([toks[0, 4 + t:5 + t], toks[1, t:t + 1]])
        lg, c = model.decode_step(c, feed)
        got[0].append(lg[0, 0])
        got[1].append(lg[1, 0])
    for row, start in ((0, 4), (1, 0)):
        solo = cache(1)
        ref = []
        for t in range(start + 6):
            lg, solo = model.decode_step(solo, toks[row:row + 1, t:t + 1])
            ref.append(lg[0, 0])
        assert _rel(torch.stack(got[row]).numpy(),
                    torch.stack(ref[start:]).numpy()) <= REL


def test_cache_dtypes_are_the_references_settled_dtypes(lm):
    """``init_cache`` lays out every leaf in the dtype the reference's
    ``decode_step`` returns it in (what the reference's server casts its
    cache to before the first step), at the server's bf16 default: the
    recurrent state float32, the conv tails in the compute dtype, the
    local attention's ring in bf16."""
    jc = lm.jm.init_cache(2, 16, jnp.bfloat16, per_row=True)
    settled = jax.eval_shape(lm.jm.decode_step, lm.jp, jc,
                             jnp.zeros((2, 1), jnp.int32))[1]
    pc = lm.pm.init_cache(2, 16, torch.bfloat16, per_row=True)
    want = {p: (str(a.dtype), a.shape) for p, a in tree_paths(settled)}
    got = {p: (str(a.dtype).replace("torch.", ""), tuple(a.shape))
           for p, a in tree_paths(pc)}
    assert got == want
    if lm.arch == "xlstm-350m":
        assert got["seg0/p0/C"][0] == "float32"
    else:
        assert got["seg0/p2/k"][0] == "bfloat16"


def _reference_greedy(lm, pair):
    """Greedy tokens of two requests ((prompt, max_new) each) through
    the reference's ``decode_step``, one per row of a per-row cache (rows
    are independent): each row's prompt fed token by token, then each
    argmax fed back; a finished row idles."""
    cache = lm.jm.init_cache(2, 16, jnp.float32, per_row=True)
    feeds = [list(p) for p, _ in pair]
    outs = [[], []]
    while any(len(o) < m for o, (_, m) in zip(outs, pair)):
        tok = [f.pop(0) if f else (o[-1] if o else 1)
               for f, o in zip(feeds, outs)]
        lg, cache = lm.step(lm.jp, cache,
                            jnp.asarray(tok, jnp.int32)[:, None])
        top = np.asarray(jnp.argmax(lg[:, 0], axis=-1))
        for r, (f, o) in enumerate(zip(feeds, outs)):
            if not f and len(o) < pair[r][1]:
                o.append(int(top[r]))
    return outs


def test_token_server_greedy_matches_reference_argmax(lm):
    """A ``TokenServer`` drain (fused route, float32 caches, ragged
    prompts, slots re-admitted mid-drain) gives each request the greedy
    tokens of the reference's ``decode_step`` run alone."""
    pcfg = lm.pcfg
    rng = np.random.default_rng(4)
    subs = [(rng.integers(1, pcfg.vocab_size,
                          int(rng.integers(3, 9))).astype(np.int32),
             int(rng.integers(2, 6))) for _ in range(6)]
    srv = pserve.TokenServer(pcfg, lm.pp, policy=pserve.BatchPolicy(**POL),
                             max_seq=32, decode_kernel=True,
                             cache_dtype=torch.float32, **CPU)
    rids = [srv.submit(p, max_new=m) for p, m in subs]
    done = srv.drain()
    want = sum((_reference_greedy(lm, subs[i:i + 2])
                for i in range(0, len(subs), 2)), [])
    assert [list(done[r].out) for r in rids] == want


def test_serve_cli_and_cuda_default(lm, capsys):
    """``launch.serve --arch <arch> --device cpu`` serves the reduced
    model through ``TokenServer``; without CUDA the default device
    raises: the model runs on the host only when asked."""
    port_launch.main(["--arch", lm.arch, "--device", "cpu", "--requests",
                      "2", "--max-new", "3"])
    assert "[serve] 2 requests, 6 tokens" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            build_model(lm.pcfg, params=lm.pp)
        with pytest.raises(RuntimeError, match="CUDA"):
            pserve.TokenServer(lm.pcfg, lm.pp)
