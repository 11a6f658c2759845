"""Port parity: multi-head latent attention (``models/mla.py``), the
transformer's MLA and multi-token prediction branches and
deepseek-v3-671b served through the port's entry points, against the
JAX reference on the host.

Layer tests draw the reference's ``init_mla`` weights (norm scales
perturbed) and hand them to the port as tensors; model tests carry
``reduced(deepseek-v3-671b)`` across with ``checkpoint/convert.py``:
d 256, 4 heads, MLA ranks 64/32/16/32/32, one dense and one MoE layer
(4 experts top-2, a shared expert), V 512, one MTP block, the embedding
scaled by 1/sqrt(d) and the norm scales perturbed.

Bars:
  * ``mla_apply`` within 1e-5 of max(1, |ref|);
  * ``mla_decode``, lockstep, per-row and paged: float32 caches, y
    within 1e-5 of max(1, |ref|) every step and the caches within 1e-5;
    bfloat16 caches, the caches' entries equal where the float32
    latents round alike (at least 98%; all of them here) and y within
    1e-4;
  * the port's absorbed decode against its own decompressed apply,
    float32: logits within 1e-4 of max(1, |apply|) (the reference holds
    its pair to rtol 0.05, atol 0.2);
  * the model: hidden, ``mtp_hidden`` and prefill logits within 1e-4 of
    max(1, |ref|), the aux within 1e-5, per-row decode logits within
    1e-5; greedy and sampled tokens equal to the reference's servers'.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.serve as jserve  # noqa: E402
import repro_torch.serve as pserve  # noqa: E402
from repro import configs as jax_configs  # noqa: E402
from repro.checkpoint.store import save_tree  # noqa: E402
from repro.launch.steps import make_loss_fn as jax_loss_fn  # noqa: E402
from repro.launch.steps import make_prefill_step as jax_prefill  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import mla as jax_mla  # noqa: E402
from repro.models import paging as jax_paging  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import load_jax_npz, params_from_numpy  # noqa: E402
from repro_torch.launch import serve as port_launch  # noqa: E402
from repro_torch.launch.steps import make_loss_fn, make_prefill_step  # noqa: E402
from repro_torch.models import build_model, layers, mla, paging  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.utils.trees import tree_paths  # noqa: E402

ARCH = "deepseek-v3-671b"
REL = 1e-5
HREL = 1e-4
ABSORBED_REL = 1e-4
BF16_REL = 1e-4
CPU = dict(device="cpu")
POL = dict(name="t", max_batch=4, bucket_multiple=16, sort_by_length=False,
           sync_every=4)
# the reference's count, jax.eval_shape of its init at the published
# widths: 61 layers, 256 experts, the MTP block; and its mtp subtree's
FULL_PARAMS = 682_636_457_984
FULL_MTP_PARAMS = 11_610_053_632


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


def _configs():
    return (jax_configs.reduced(jax_configs.get_arch(ARCH)),
            configs.reduced(configs.get_arch(ARCH)))


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict)
            else torch.tensor(np.asarray(v)) for k, v in tree.items()}


# ----------------------------------------------------------------- layer

@pytest.fixture(scope="module")
def layer():
    """(reference cfg, port cfg, numpy params, torch params)."""
    jcfg, pcfg = _configs()
    p = jax.tree_util.tree_map(np.array, jax.device_get(
        jax_mla.init_mla(jax.random.key(1), jcfg)))
    rng = np.random.default_rng(1)
    for norm in ("q_norm", "kv_norm"):
        p[norm]["scale"] = (0.1 * rng.normal(
            size=p[norm]["scale"].shape)).astype(np.float32)
    return jcfg, pcfg, p, _torch_tree(p)


@pytest.mark.parametrize("s", [37, 530])
def test_mla_apply_matches_reference(layer, s):
    """S = 530 crosses the plain path's 512-query chunk, unaligned."""
    jcfg, pcfg, p, tp = layer
    x = np.random.default_rng(s).normal(size=(2, s, pcfg.d_model)).astype(
        np.float32)
    want = jax.jit(jax_mla.mla_apply, static_argnums=1)(
        p, jcfg, jnp.asarray(x), jnp.arange(s))
    got = mla.mla_apply(tp, pcfg, torch.from_numpy(x))
    assert got.shape == x.shape
    assert _rel(got.numpy(), want) <= REL


_jax_decode = jax.jit(jax_mla.mla_decode, static_argnums=1)


def _jax_paged_decode(p, jcfg, x, cache, pos, tables, caps, page_size):
    return jax_mla.mla_decode(p, jcfg, x, cache, pos,
                              pages=jax_paging.PageRef(tables, caps,
                                                       page_size))


_jax_paged = jax.jit(_jax_paged_decode, static_argnums=(1, 7))

B, SLOTS, STEPS = 3, 16, 9
PAGE = 4
STARTS = [0, 5, 11]          # row 2 runs past the 16-slot cache


def _pages():
    """A block table over 3 rows of 4 blocks of 4 (pages 1..12 shuffled,
    row 2's last block unallocated) and their capacities."""
    ids = np.random.default_rng(5).permutation(np.arange(1, 13)).astype(
        np.int32).reshape(B, 4)
    ids[2, 3] = 0
    return ids, np.asarray([16, 16, 12], np.int32)


def _run_decode(layer, route, dtype):
    """STEPS decode steps of both packages from zero caches: per step
    (port y, reference y), and the final caches (port, reference) as
    float32 numpy, pools without trash page 0."""
    jcfg, pcfg, p, tp = layer
    rng = np.random.default_rng(7)
    xs = rng.normal(size=(STEPS, B, 1, pcfg.d_model)).astype(np.float32)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    pg = None
    if route == "paged":
        tables, caps = _pages()
        pg = paging.PagedCacheConfig(page_size=PAGE, n_pages=12,
                                     max_ctx=SLOTS)
        ref = paging.PageRef(torch.from_numpy(tables), torch.from_numpy(caps),
                             PAGE)
    pc = mla.init_mla_cache(pcfg, B, SLOTS, dtype, paging=pg, **CPU)
    jc = jax_mla.init_mla_cache(jcfg, B, SLOTS, jdt,
                                paging=None if pg is None else
                                jax_paging.PagedCacheConfig(
                                    page_size=PAGE, n_pages=12,
                                    max_ctx=SLOTS))
    ys = []
    for t in range(STEPS):
        if route == "lockstep":
            pos = np.int32(t + 10)                 # past 16: clamped write
        else:
            pos = np.asarray(STARTS, np.int32) + t
        x = torch.from_numpy(xs[t])
        tpos = torch.tensor(pos)
        if route == "paged":
            y, pc = mla.mla_decode(tp, pcfg, x, pc, tpos,
                                   pages=paging.step_slots(ref, tpos))
            jy, jc = _jax_paged(p, jcfg, jnp.asarray(xs[t]), jc,
                                jnp.asarray(pos), jnp.asarray(tables),
                                jnp.asarray(caps), PAGE)
        else:
            y, pc = mla.mla_decode(tp, pcfg, x, pc, tpos)
            jy, jc = _jax_decode(p, jcfg, jnp.asarray(xs[t]), jc,
                                 jnp.asarray(pos))
        ys.append((y.numpy(), np.asarray(jy, np.float32)))
    cut = PAGE if route == "paged" else 0
    caches = {k: (pc[k].float().numpy()[cut:],
                  np.asarray(jc[k], np.float32)[cut:]) for k in pc}
    return ys, caches


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("route", ["lockstep", "per_row", "paged"])
def test_mla_decode_matches_reference(layer, route, dtype):
    """float32 caches: y and the caches within 1e-5.  A bfloat16 cache
    rounds the new token, which the step reads back from the cache as
    the reference does: entries equal where the float32 latents round
    alike (all but a few), y within BF16_REL."""
    ys, caches = _run_decode(layer, route, getattr(torch, dtype))
    bar = REL if dtype == "float32" else BF16_REL
    for t, (y, want) in enumerate(ys):
        assert _rel(y, want) <= bar, (route, t)
    for key, (got, want) in caches.items():
        assert np.abs(want).max() > 0.1, key             # written
        if dtype == "float32":
            assert _rel(got, want) <= REL, key
            continue
        assert (got == want).mean() > 0.98, key
        # a flip is one bf16 unit
        assert np.abs(got - want).max() <= 2 ** -7 * max(
            1.0, np.abs(want).max()), key


def test_decode_reads_the_rounded_token(layer):
    """With a bfloat16 cache the step reads the new token back from the
    cache, rounded, as the reference does: from one history, the
    port's output equals the reference's within 1e-5 and differs from a
    float32 cache's, which holds the token unrounded."""
    jcfg, pcfg, p, tp = layer
    rng = np.random.default_rng(8)
    x = rng.normal(size=(B, 1, pcfg.d_model)).astype(np.float32)
    pos = np.asarray([3, 0, 7], np.int32)
    hist = {k: torch.from_numpy(rng.normal(size=a.shape).astype(
        np.float32)).bfloat16().float().numpy()
        for k, a in mla.init_mla_cache(pcfg, B, SLOTS, torch.float32,
                                       **CPU).items()}
    y16, _ = mla.mla_decode(tp, pcfg, torch.from_numpy(x), {
        k: torch.from_numpy(a).bfloat16() for k, a in hist.items()},
        torch.from_numpy(pos))
    y32, _ = mla.mla_decode(tp, pcfg, torch.from_numpy(x), {
        k: torch.from_numpy(a.copy()) for k, a in hist.items()},
        torch.from_numpy(pos))
    want, _ = _jax_decode(p, jcfg, jnp.asarray(x), {
        k: jnp.asarray(a, jnp.bfloat16) for k, a in hist.items()},
        jnp.asarray(pos))
    assert _rel(y16.numpy(), want) <= REL
    assert _rel(y16.numpy(), y32.numpy()) > 10 * REL


# ----------------------------------------------------------------- model

def _nest(flat):
    tree = {}
    for path, a in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = jnp.asarray(a)
    return tree


@pytest.fixture(scope="module")
def lm():
    """Reduced deepseek-v3-671b in both packages on the same weights:
    (reference cfg, port cfg, reference model, reference params, port
    params, port model, the reference's init as drawn)."""
    jcfg, pcfg = _configs()
    jm = jax_build_model(jcfg)
    params = jax.device_get(jax.jit(jm.init)(jax.random.key(3)))
    rng = np.random.default_rng(3)
    flat = {}
    for path, a in tree_paths(params):
        a = np.array(a, np.float32)
        if path == "embed":
            a = a / np.sqrt(jcfg.d_model)
        elif path.endswith("scale"):
            a = (0.1 * rng.normal(size=a.shape)).astype(np.float32)
        flat[path] = a
    pp = params_from_numpy(flat, pcfg, **CPU)
    return (jcfg, pcfg, jm, _nest(flat), pp,
            build_model(pcfg, params=pp, **CPU), params)


def _tokens(cfg, b=2, s=40, seed=0):
    return np.random.default_rng(seed).integers(
        1, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", [ARCH, ARCH + "+swa"])
def test_registry_builds_mla_and_mtp(arch, lm):
    cfg = configs.get_arch(arch)
    assert cfg.mla is not None and cfg.mtp_depth == 1
    assert set(configs.ARCHS) == set(jax_configs.ARCHS)
    assert ARCH in configs.ARCHS
    m = Transformer(cfg, device="meta", generator=None)
    sd = m.state_dict()
    assert tuple(sd["seg0.0.p0.mixer.w_uq"].shape) == (1536, 128 * 192)
    assert tuple(sd["seg0.0.p0.mixer.w_dkv"].shape) == (7168, 512 + 64)
    assert tuple(sd["seg1.57.p0.ffn.w_gate"].shape) == (256, 7168, 2048)
    assert tuple(sd["mtp.proj"].shape) == (2 * 7168, 7168)
    assert tuple(sd["mtp.block.0.ffn.w_down"].shape) == (256, 2048, 7168)
    assert not any(n.startswith("mtp.block.1.") for n in sd)
    _, pcfg, _, _, pp, pm, _ = lm
    assert {n for n in pp if n.startswith("mtp.")} == \
        {n for n in pm.state_dict() if n.startswith("mtp.")}


def test_parameter_count_equals_reference():
    """On ``meta`` at the published widths: the reference's count."""
    m = Transformer(configs.get_arch(ARCH), device="meta", generator=None)
    assert sum(p.numel() for p in m.parameters()) == FULL_PARAMS
    mtp = sum(p.numel() for p in m.mtp.parameters())
    assert mtp == FULL_MTP_PARAMS


def test_apply_hidden_aux_and_mtp_match_reference(lm):
    jcfg, pcfg, jm, jp, _, pm, _ = lm
    tok = _tokens(pcfg)
    jh, jaux = jax.jit(jm.apply)(jp, jnp.asarray(tok))
    shifted = np.roll(tok, -1, axis=1)
    jmtp = jax.jit(jm.mtp_hidden)(jp, jh, jnp.asarray(shifted),
                                  jnp.arange(tok.shape[1]))
    with torch.no_grad():
        ph, paux = pm.apply(torch.from_numpy(tok))
        pmtp = pm.mtp_hidden(ph, torch.from_numpy(shifted))
        # explicit positions, as the reference passes them
        pmtp_pos = pm.mtp_hidden(ph, torch.from_numpy(shifted),
                                 torch.arange(tok.shape[1]))
    assert _rel(ph.numpy(), jh) <= HREL
    assert set(paux) == set(jaux) == {f"seg1/p0/moe_{n}" for n in
                                      ("lb_loss", "z_loss", "drop_frac")}
    for key, v in jaux.items():
        assert _rel(float(paux[key]), float(v)) <= REL, key
    assert pmtp.shape == ph.shape and torch.equal(pmtp, pmtp_pos)
    assert _rel(pmtp.numpy(), jmtp) <= HREL
    plain = build_model(pcfg.replace(mtp_depth=0), params={
        k: v for k, v in pm.state_dict().items()
        if not k.startswith("mtp.")}, **CPU)
    assert plain.mtp_hidden(ph, torch.from_numpy(shifted)) is None


def test_prefill_step_matches_reference(lm):
    jcfg, pcfg, jm, jp, _, pm, _ = lm
    tok = _tokens(pcfg, seed=1)
    want = jax.jit(jax_prefill(jm, jcfg))(jp, {"tokens": jnp.asarray(tok)})
    got = make_prefill_step(pm, pcfg)({"tokens": tok})
    assert got.shape == (2, 1, pcfg.vocab_size) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= HREL


def test_absorbed_decode_matches_decompressed_apply(lm):
    """The port's two MLA forms on one prompt, float32: each decode
    step's logits against ``apply``'s at that position."""
    _, pcfg, _, _, _, pm, _ = lm
    tok = _tokens(pcfg, b=2, s=24, seed=4)
    with torch.no_grad():
        h, _ = pm.apply(torch.from_numpy(tok))
        full = pm.unembed(h).numpy()
    cache = pm.init_cache(2, 24, torch.float32, per_row=True)
    for t in range(tok.shape[1]):
        lg, cache = pm.decode_step(cache, torch.from_numpy(tok[:, t:t + 1]))
        assert _rel(lg[:, 0].numpy(), full[:, t]) <= ABSORBED_REL, t


def test_per_row_decode_matches_reference(lm):
    """Ragged rows over a float32 per-row cache, 10 teacher-forced
    steps, ``decode_kernel`` off and on (MLA ignores it): logits within
    1e-5 each step."""
    jcfg, pcfg, jm, jp, pp, _, _ = lm
    toks = _tokens(pcfg, b=3, s=10, seed=2)
    jc = jm.init_cache(3, 32, jnp.float32, per_row=True)
    jc["pos"] = jnp.asarray([0, 5, 11], jnp.int32)
    step = jax.jit(jm.decode_step)
    want = []
    for t in range(toks.shape[1]):
        logits, jc = step(jp, jc, jnp.asarray(toks[:, t:t + 1]))
        want.append(np.asarray(logits))
    for decode_kernel in (False, True):
        pm = build_model(pcfg, params=pp, decode_kernel=decode_kernel, **CPU)
        pc = pm.init_cache(3, 32, torch.float32, per_row=True)
        pc["pos"] = torch.tensor([0, 5, 11], dtype=torch.int32)
        for t in range(toks.shape[1]):
            got, pc = pm.decode_step(pc, torch.from_numpy(toks[:, t:t + 1]))
            assert _rel(got.numpy(), want[t]) <= REL, (decode_kernel, t)


def test_shared_rope_tables_at_the_rope_dim(lm, monkeypatch):
    """A per-row step computes its RoPE tables once, at
    ``qk_rope_head_dim`` (16 here; the config's head dim is 64), for
    every MLA layer, on the fused route and on a paged cache alike; the
    logits stay the reference's."""
    jcfg, pcfg, jm, jp, pp, _, _ = lm
    dims = []
    real = layers.rope_tables

    def spy(positions, dim, theta):
        dims.append(dim)
        return real(positions, dim, theta)
    monkeypatch.setattr(layers, "rope_tables", spy)
    tok = _tokens(pcfg, b=2, s=1, seed=6)
    jc = jm.init_cache(2, 16, jnp.float32, per_row=True)
    jc["pos"] = jnp.asarray([0, 3], jnp.int32)
    want, _ = jax.jit(jm.decode_step)(jp, jc, jnp.asarray(tok))
    for kw in (dict(decode_kernel=True),
               dict(paging=paging.PagedCacheConfig(page_size=4, n_pages=8,
                                                   max_ctx=16))):
        pm = build_model(pcfg, params=pp, **kw, **CPU)
        pc = pm.init_cache(2, 16, torch.float32, per_row=True)
        if "paging" in kw:
            pc["pages"]["tables"][:] = torch.tensor([[1, 2, 3, 4],
                                                     [5, 6, 7, 8]])
            pc["pages"]["caps"][:] = 16
        pc["pos"] = torch.tensor([0, 3], dtype=torch.int32)
        dims.clear()
        got, _ = pm.decode_step(pc, torch.from_numpy(tok))
        assert dims == [pcfg.mla.qk_rope_head_dim], kw
        assert _rel(got.numpy(), want) <= REL, kw
    assert pcfg.resolved_head_dim != pcfg.mla.qk_rope_head_dim


def _requests(seed, n, vocab, sampled=()):
    rng = np.random.default_rng(seed)
    subs = []
    for i in range(n):
        prompt = rng.integers(1, vocab, int(rng.integers(3, 12))).astype(
            np.int32)
        subs.append((prompt, int(rng.integers(3, 9)),
                     sampled[i] if i < len(sampled) else None))
    return subs


def _drain(srv, subs, pkg=None):
    """Submit (prompt, max_new, sampling dict or None) each, drain, and
    return the tokens in order; ``pkg`` (the server's package) makes
    the ``SamplingParams``, None submits without them."""
    rids = [srv.submit(p, max_new=m) if pkg is None else
            srv.submit(p, max_new=m, sampling=None if s is None
                       else pkg.SamplingParams(**s)) for p, m, s in subs]
    done = srv.drain()
    return [list(done[r].out) for r in rids]


def test_token_server_matches_reference(lm):
    """Greedy and sampled requests in one drain through the fused
    sampler: tokens and counts equal the reference's."""
    jcfg, pcfg, _, jp, pp, _, _ = lm
    samp = [dict(temperature=1.0, top_k=20, top_p=0.95, seed=7),
            dict(temperature=0.7, top_k=8, top_p=0.9, seed=8), None,
            dict(temperature=1.3, top_k=32, top_p=1.0, seed=9)]
    subs = _requests(4, 7, pcfg.vocab_size, samp)
    js = jserve.TokenServer(jcfg, jp, policy=jserve.BatchPolicy(**POL),
                            max_seq=64, decode_kernel=True)
    ps = pserve.TokenServer(pcfg, pp, policy=pserve.BatchPolicy(**POL),
                            max_seq=64, decode_kernel=True, **CPU)
    got = _drain(ps, subs, pserve)
    assert got == _drain(js, subs, jserve)
    assert len(set(sum(got, []))) > 8              # it really samples
    for k in ("syncs", "steps", "active_slot_steps"):
        assert ps.stats[k] == js.stats[k], k


def test_round_server_and_paged_drain_match(lm):
    """``RoundTokenServer`` tokens equal the reference's; a paged drain
    (prefix cache on: the latent pools' pages are shared) equals the
    port's contiguous one, and its prefix hits the reference's paged
    server's."""
    jcfg, pcfg, _, jp, pp, _, _ = lm
    rng = np.random.default_rng(10)
    subs = [(rng.integers(1, pcfg.vocab_size, ln).astype(np.int32),
             int(rng.integers(2, 8)), None) for ln in (5, 5, 7, 5, 7)]
    js = jserve.RoundTokenServer(jcfg, jp, policy=jserve.BatchPolicy(**POL),
                                 max_seq=64, cache_dtype=jnp.float32)
    ps = pserve.RoundTokenServer(pcfg, pp, policy=pserve.BatchPolicy(**POL),
                                 max_seq=64, cache_dtype=torch.float32, **CPU)
    assert _drain(ps, subs) == _drain(js, subs)
    pre = rng.integers(1, pcfg.vocab_size, 16).astype(np.int32)
    shared = [(np.concatenate([pre, p]) if i % 2 else p, m, None)
              for i, (p, m, _) in enumerate(_requests(11, 8,
                                                      pcfg.vocab_size))]
    pol = pserve.BatchPolicy(**POL)
    pkw = dict(page_size=8, n_pages=32, max_ctx=64)
    paged = pserve.TokenServer(
        pcfg, pp, policy=pol, cache_dtype=torch.float32,
        paging=paging.PagedCacheConfig(**pkw), **CPU)
    cont = pserve.TokenServer(pcfg, pp, policy=pol, max_seq=64,
                              cache_dtype=torch.float32, **CPU)
    got = _drain(paged, shared)
    assert got == _drain(cont, shared)
    jpaged = jserve.TokenServer(
        jcfg, jp, policy=jserve.BatchPolicy(**POL), cache_dtype=jnp.float32,
        paging=jax_paging.PagedCacheConfig(**pkw))
    assert _drain(jpaged, shared) == got
    assert paged.paging_stats()["hits"] == jpaged.paging_stats()["hits"] > 0
    paged.alloc.check()
    assert paged.alloc.live_pages() == 0


def test_weight_bridge_round_trip(lm, tmp_path):
    """The reference's ``mtp/block`` leaves (a stack of one) through its
    own checkpoint file: ``load_jax_npz`` + ``params_from_numpy`` give
    ``mtp.block.0.*`` bitwise, and every port tensor restacks to the
    reference's array."""
    _, pcfg, _, _, _, _, params = lm
    save_tree(str(tmp_path / "ckpt"), params)
    flat = load_jax_npz(str(tmp_path / "ckpt"))
    e, d, f = pcfg.n_experts, pcfg.d_model, pcfg.moe_d_ff
    assert flat["mtp/block/ffn/w_gate"].shape == (1, e, d, f)
    assert flat["mtp/proj"].shape == (2 * d, d)
    sd = params_from_numpy(flat, pcfg, **CPU)
    assert tuple(sd["mtp.block.0.mixer.w_uk"].shape) == \
        (pcfg.mla.kv_lora_rank, pcfg.n_heads * pcfg.mla.qk_nope_head_dim)
    sd = build_model(pcfg, params=sd, **CPU).state_dict()
    for path, a in tree_paths(params):
        head = path.split("/")[0]
        if head.startswith("seg") or path.startswith("mtp/block/"):
            n = np.shape(a)[0]
            pre = "mtp/block" if path.startswith("mtp/block/") else head
            name = path[len(pre) + 1:].replace("/", ".")
            pre = pre.replace("/", ".")
            back = np.stack([sd[f"{pre}.{g}.{name}"].numpy()
                             for g in range(n)])
        else:
            back = sd[path.replace("/", ".")].numpy()
        np.testing.assert_array_equal(back, np.asarray(a), err_msg=path)
    assert len(sd) == len(tree_paths(params))     # every stack is of one


def test_serve_cli_and_cuda_default(lm, capsys):
    """``launch.serve --arch deepseek-v3-671b --device cpu`` serves the
    reduced model; without CUDA the default device raises; the LM loss
    (MTP's only consumer) equals the reference's: its CE, the MoE
    load-balancing sum and the total with the MoE aux and MTP terms."""
    port_launch.main(["--arch", ARCH, "--device", "cpu", "--requests", "2",
                      "--max-new", "3"])
    assert "[serve] 2 requests, 6 tokens" in capsys.readouterr().out
    jcfg, pcfg, jm, jp, pp, pm, _ = lm
    tok = _tokens(pcfg, s=17, seed=8)
    batch = {"tokens": tok, "labels": np.roll(tok, -1, 1)}
    _, want = jax.jit(jax_loss_fn(jm, jcfg, "ce"))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        _, got = make_loss_fn(pm, pcfg, "ce")(pp, batch)
    assert set(got) == set(want) == {"loss", "moe_lb", "total_loss"}
    for k in got:
        assert _rel(float(got[k]), float(want[k])) <= 1e-5, k
    assert float(got["total_loss"]) > float(got["loss"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            build_model(pcfg, params=pp)
        with pytest.raises(RuntimeError, match="CUDA"):
            pserve.TokenServer(pcfg, pp)
