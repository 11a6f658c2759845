"""Port parity: the mixture-of-experts channel mixer (``models/moe.py``),
the transformer's ``moe`` branch and qwen3-moe-30b-a3b served through
the port's entry points, against the JAX reference on the host.

Layer tests draw the reference's ``init_moe`` weights and hand them to
the port as tensors; model tests carry a reduced qwen3-moe-30b-a3b (two
layers, 4 experts, top-2) across with ``checkpoint/convert.py``, its
embedding scaled by 1/sqrt(d) and its norm scales perturbed, at
``capacity_factor`` 1.0 so that a 48-token prompt drops assignments.

Bars:
  * ``capacity`` equal for N in 1..4096;
  * ``moe_apply``: routing ids, per-group expert counts and drops
    bitwise, y within 1e-5 of max(1, |ref|), each aux within 1e-6 of
    max(1, |ref|); ties to the smallest expert id;
  * the model: hidden and prefill logits within 1e-4 of max(1, |ref|)
    (two layers of float32 products summed in other orders), the aux
    within 1e-5, per-row decode logits within 1e-5;
  * servers: greedy and sampled tokens equal to the reference's
    ``TokenServer``'s, ``RoundTokenServer``'s equal, and a paged drain
    equal to the port's contiguous one.
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
from repro.configs.base import Segment as JaxSegment  # noqa: E402
from repro.launch.steps import make_prefill_step as jax_prefill  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import load_jax_npz, params_from_numpy  # noqa: E402
from repro_torch.configs.base import Segment  # noqa: E402
from repro_torch.launch import serve as port_launch  # noqa: E402
from repro_torch.launch.steps import make_prefill_step  # noqa: E402
from repro_torch.models import build_model, moe, paging  # noqa: E402
from repro_torch.utils.trees import tree_paths  # noqa: E402

ARCH = "qwen3-moe-30b-a3b"
REL = 1e-5
AUX_REL = 1e-6
HREL = 1e-4
MODEL_AUX_REL = 1e-5
CPU = dict(device="cpu")
S = 48
POL = dict(name="t", max_batch=4, bucket_multiple=16, sort_by_length=False,
           sync_every=4)


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


def _reduced(**kw):
    return (jax_configs.reduced(jax_configs.get_arch(ARCH)).replace(**kw),
            configs.reduced(configs.get_arch(ARCH)).replace(**kw))


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict)
            else torch.tensor(np.asarray(v)) for k, v in tree.items()}


# ----------------------------------------------------------------- layer

def test_capacity_matches_reference():
    for factor in (0.5, 1.0, 1.25, 4.0):
        for cfg in (configs.get_arch(ARCH), _reduced()[1]):
            c = cfg.replace(capacity_factor=factor)
            assert [moe.capacity(n, c) for n in range(1, 4097)] == \
                [jax_moe.capacity(n, c) for n in range(1, 4097)]
    assert moe.capacity(1, configs.get_arch(ARCH)) == 8
    assert moe.capacity(2048, configs.get_arch(ARCH)) == 160


def _layer(case, seed=0):
    """(reference cfg, port cfg, numpy params, x (B,S,D)) for a case."""
    kw = {"nodrop": dict(capacity_factor=4.0),
          "drops": dict(capacity_factor=1.0),
          "shared": dict(n_shared_experts=1),
          "no_renorm": dict(moe_renorm_topk=False),
          "ties": {}}[case]
    jcfg, pcfg = _reduced(**kw)
    p = jax.tree_util.tree_map(np.array, jax.device_get(
        jax_moe.init_moe(jax.random.key(seed), jcfg)))
    rng = np.random.default_rng(seed)
    d = pcfg.d_model
    # a router of N(0, 1/d) columns: logits of unit spread
    p["router"] = (rng.normal(size=p["router"].shape) / np.sqrt(d)).astype(
        np.float32)
    x = rng.normal(size=(3, S, d)).astype(np.float32)
    if case == "drops":
        # experts 0 and 1 favoured by a shared offset of every token
        p["router"][:, 0] += 0.02
        p["router"][:, 1] += 0.01
        x = x + np.float32(0.2)
    elif case == "ties":
        # experts 1, 2 and 3 tie on every token, so the top-2 boundary
        # falls inside the tie; half the tokens see all four equal
        p["router"][:, 2] = p["router"][:, 1]
        p["router"][:, 3] = p["router"][:, 1]
        x[:, ::2] = 0.0
    return jcfg, pcfg, p, x


_reference_moe = jax.jit(jax_moe.moe_apply, static_argnums=1)


def _routing_body(p, x, jcfg):
    """The reference's routing and per-group dispatch, as its
    ``moe_apply`` computes them: (top_p, top_i, counts (B,E), dropped
    (B,))."""
    b, s, d = x.shape
    k = jcfg.moe_top_k
    xt = x.reshape(b * s, d)
    probs = jax.nn.softmax((xt @ p["router"]).astype(jnp.float32), axis=-1)
    top_p, top_i = jax.lax.top_k(probs, k)
    if jcfg.moe_renorm_topk:
        top_p = top_p / jnp.maximum(top_p.sum(-1, keepdims=True), 1e-9)
    cap = jax_moe.capacity(s, jcfg)
    _, counts, dropped = jax.vmap(
        lambda xg, pg, ig: jax_moe._group_dispatch_combine(
            xg, pg, ig, p["w_gate"], p["w_up"], p["w_down"],
            e=jcfg.n_experts, k=k, cap=cap, act=jcfg.act))(
        xt.reshape(b, s, d), top_p.reshape(b, s, k), top_i.reshape(b, s, k))
    return top_p, top_i, counts, dropped


_reference_routing_jit = jax.jit(_routing_body, static_argnums=2)


def _reference_routing(jcfg, p, x):
    return tuple(np.asarray(a) for a in _reference_routing_jit(
        {w: p[w] for w in ("router", "w_gate", "w_up", "w_down")},
        jnp.asarray(x), jcfg))


def _port_routing(pcfg, tp, x):
    b, s, _ = x.shape
    k = pcfg.moe_top_k
    xt = torch.from_numpy(x)
    _, _, top_p, top_i = moe.route(tp, pcfg, xt)
    _, counts, dropped = moe._group_dispatch_combine(
        xt, top_p.reshape(b, s, k), top_i.reshape(b, s, k), tp["w_gate"],
        tp["w_up"], tp["w_down"], cap=moe.capacity(s, pcfg))
    return top_p.numpy(), top_i.numpy(), counts.numpy(), dropped.numpy()


@pytest.mark.parametrize("case", ["nodrop", "drops", "shared", "no_renorm"])
def test_moe_apply_matches_reference(case):
    jcfg, pcfg, p, x = _layer(case)
    tp = _torch_tree(p)
    want_y, want_aux = _reference_moe(p, jcfg, jnp.asarray(x))
    got_y, got_aux = moe.moe_apply(tp, pcfg, torch.from_numpy(x))
    jp_, ji, jcounts, jdrop = _reference_routing(jcfg, p, x)
    pp_, pi, pcounts, pdrop = _port_routing(pcfg, tp, x)
    np.testing.assert_array_equal(pi, ji)                 # routing ids
    np.testing.assert_array_equal(pcounts, jcounts)       # per group
    np.testing.assert_array_equal(pdrop, jdrop)
    assert _rel(pp_, jp_) <= REL
    assert _rel(got_y.numpy(), want_y) <= REL
    assert set(got_aux) == set(want_aux) == {"moe_lb_loss", "moe_z_loss",
                                             "moe_drop_frac"}
    for name, v in want_aux.items():
        assert got_aux[name].dim() == 0
        assert _rel(float(got_aux[name]), float(v)) <= AUX_REL, name
    drop = float(want_aux["moe_drop_frac"])
    if case == "drops":          # many overflow, and not all the same way
        assert 0.05 < drop < 0.5
        assert len({tuple(sorted(r)) for r in pi}) > 2
    else:
        assert drop == 0.0
    if case == "no_renorm":
        assert (pp_.sum(-1) < 1 - 1e-3).all()


def test_ties_go_to_the_smallest_ids():
    jcfg, pcfg, p, x = _layer("ties")
    tp = _torch_tree(p)
    jp_, ji, jcounts, jdrop = _reference_routing(jcfg, p, x)
    pp_, pi, pcounts, pdrop = _port_routing(pcfg, tp, x)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(pcounts, jcounts)
    # the all-equal tokens (x = 0) take experts 0 and 1; every other
    # token [0, 1] (expert 0 ahead) or [1, 2] (behind): never expert 3
    zero = np.zeros((3, S), bool)
    zero[:, ::2] = True
    zero = zero.reshape(-1)
    np.testing.assert_array_equal(pi[zero], np.tile([0, 1], (zero.sum(), 1)))
    rows = {tuple(r) for r in pi[~zero]}
    assert rows == {(0, 1), (1, 2)}
    got, _ = moe.moe_apply(tp, pcfg, torch.from_numpy(x))
    want, _ = _reference_moe(p, jcfg, jnp.asarray(x))
    assert _rel(got.numpy(), want) <= REL
    # all equal through the op itself, ids ascending
    vals, ids = moe.top_k(torch.full((5, 128), 0.25), 8)
    assert (ids == torch.arange(8)).all() and (vals == 0.25).all()


def test_row_output_ignores_other_rows_with_drops():
    """Each row is its own routing group: with drops on, changing row
    1's tokens leaves rows 0 and 2 bitwise."""
    _, pcfg, p, x = _layer("drops")
    tp = _torch_tree(p)
    y0, aux0 = moe.moe_apply(tp, pcfg, torch.from_numpy(x))
    x2 = x.copy()
    x2[1] = np.random.default_rng(9).normal(size=x2[1].shape) + 0.2
    y1, aux1 = moe.moe_apply(tp, pcfg, torch.from_numpy(x2))
    assert float(aux0["moe_drop_frac"]) > 0
    assert torch.equal(y0[0], y1[0]) and torch.equal(y0[2], y1[2])
    assert not torch.equal(y0[1], y1[1])


@pytest.mark.parametrize("b,s", [(16, 1), (2, 2048)])
def test_moe_apply_runs_on_meta_tensors(b, s):
    """No data-dependent shape and no host read: the layer runs on the
    meta device at the published widths (a decode step's 16 rows and a
    2,048-token prefill), where no value exists."""
    cfg = configs.get_arch(ARCH).replace(n_shared_experts=1)
    params = moe.init_moe(cfg, generator=None, device="meta")
    x = torch.empty((b, s, cfg.d_model), device="meta")
    y, aux = moe.moe_apply(params, cfg, x)
    assert y.shape == x.shape and y.device.type == "meta"
    assert all(v.shape == () and v.device.type == "meta"
               for v in aux.values())
    assert tuple(params["w_gate"].shape) == (128, 2048, 768)
    assert tuple(params["w_down"].shape) == (128, 768, 2048)
    assert tuple(params["shared"]["up"].shape) == (2048, 768)


def test_init_is_seeded_and_scaled():
    _, pcfg = _reduced(n_shared_experts=1)
    a = moe.init_moe(pcfg, generator=torch.Generator().manual_seed(2),
                     device="cpu")
    b = moe.init_moe(pcfg, generator=torch.Generator().manual_seed(2),
                     device="cpu")
    for name in ("router", "w_gate", "w_up", "w_down"):
        assert torch.equal(a[name], b[name])
    d, f = pcfg.d_model, pcfg.moe_d_ff
    assert abs(float(a["router"].std()) - 0.1 / np.sqrt(d)) < 1e-3
    assert abs(float(a["w_gate"].std()) - 1 / np.sqrt(d)) < 2e-3
    assert abs(float(a["w_down"].std()) - 1 / np.sqrt(f)) < 3e-3
    assert set(a["shared"]) == {"up", "gate", "down"}


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
    """Reduced qwen3-moe-30b-a3b at two layers, capacity factor 1.0, a
    shared expert (deepseek-v3's kind), in both packages on the same
    weights: (reference cfg, port cfg, reference model, reference
    params, port params, port model, the reference's init as drawn)."""
    jcfg, pcfg = _reduced(capacity_factor=1.0, n_shared_experts=1)
    jcfg = jcfg.replace(segments=(JaxSegment(jcfg.segments[0].pattern, 2),))
    pcfg = pcfg.replace(segments=(Segment(pcfg.segments[0].pattern, 2),))
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


def _tokens(cfg, b=2, s=S, seed=0):
    return np.random.default_rng(seed).integers(
        1, cfg.vocab_size, (b, s)).astype(np.int32)


def test_registry_and_layout(lm):
    _, pcfg, _, _, pp, pm, _ = lm
    assert configs.get_arch(ARCH).name == ARCH
    assert configs.get_arch(ARCH + "+swa").segments[0].pattern[0].ffn == "moe"
    assert ARCH not in configs.NOT_PORTED
    assert set(configs.NOT_PORTED) == {"recurrentgemma-2b",
                                       "deepseek-v3-671b", "xlstm-350m"}
    e, d, f = pcfg.n_experts, pcfg.d_model, pcfg.moe_d_ff
    assert tuple(pp["seg0.1.p0.ffn.w_gate"].shape) == (e, d, f)
    assert tuple(pp["seg0.1.p0.ffn.w_down"].shape) == (e, f, d)
    assert tuple(pp["seg0.0.p0.ffn.router"].shape) == (d, e)
    assert not any(".mlp" in n or "ffn.up" in n for n in pm.state_dict())


def test_apply_hidden_and_aux_match_reference(lm):
    jcfg, pcfg, jm, jp, _, pm, _ = lm
    tok = _tokens(pcfg)
    jh, jaux = jax.jit(jm.apply)(jp, jnp.asarray(tok))
    with torch.no_grad():
        ph, paux = pm.apply(torch.from_numpy(tok))
    assert _rel(ph.numpy(), jh) <= HREL
    assert set(paux) == set(jaux) == {f"seg0/p0/moe_{n}" for n in
                                      ("lb_loss", "z_loss", "drop_frac")}
    for key, v in jaux.items():
        assert _rel(float(paux[key]), float(v)) <= MODEL_AUX_REL, key
    # summed over the segment's two layers, and some assignments drop
    assert 0 < float(paux["seg0/p0/moe_drop_frac"]) < 2


def test_prefill_step_matches_reference(lm):
    jcfg, pcfg, jm, jp, _, pm, _ = lm
    tok = _tokens(pcfg, seed=1)
    want = jax.jit(jax_prefill(jm, jcfg))(jp, {"tokens": jnp.asarray(tok)})
    got = make_prefill_step(pm, pcfg)({"tokens": tok})
    assert got.shape == (2, 1, pcfg.vocab_size) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= HREL


def test_per_row_decode_matches_reference(lm):
    """Ragged rows over a float32 per-row cache, 10 teacher-forced
    steps: logits within 1e-5 each step."""
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
    """Greedy and sampled requests in one drain through the fused route
    (``decode_kernel``: the fused attention and sampler, their plain
    versions here): tokens equal the reference's.  The non-fused
    route's per-row logits are ``test_per_row_decode_matches_reference``'s."""
    decode_kernel = True
    jcfg, pcfg, _, jp, pp, _, _ = lm
    samp = [dict(temperature=1.0, top_k=20, top_p=0.95, seed=7),
            dict(temperature=0.7, top_k=8, top_p=0.9, seed=8), None,
            dict(temperature=1.3, top_k=32, top_p=1.0, seed=9)]
    subs = _requests(4, 7, pcfg.vocab_size, samp)
    js = jserve.TokenServer(jcfg, jp, policy=jserve.BatchPolicy(**POL),
                            max_seq=64, decode_kernel=decode_kernel)
    ps = pserve.TokenServer(pcfg, pp, policy=pserve.BatchPolicy(**POL),
                            max_seq=64, decode_kernel=decode_kernel, **CPU)
    got = _drain(ps, subs, pserve)
    assert got == _drain(js, subs, jserve)
    assert len(set(sum(got, []))) > 8              # it really samples
    for k in ("syncs", "steps", "active_slot_steps"):
        assert ps.stats[k] == js.stats[k], k


def test_round_server_and_paged_drain_match(lm):
    """``RoundTokenServer`` tokens equal the reference's; a paged drain
    (prefix cache on) equals the port's contiguous one."""
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
    paged = pserve.TokenServer(
        pcfg, pp, policy=pol, decode_kernel=True, cache_dtype=torch.float32,
        paging=paging.PagedCacheConfig(page_size=8, n_pages=32, max_ctx=64),
        **CPU)
    cont = pserve.TokenServer(pcfg, pp, policy=pol, max_seq=64,
                              decode_kernel=True, cache_dtype=torch.float32,
                              **CPU)
    assert _drain(paged, shared) == _drain(cont, shared)
    assert paged.paging_stats()["hits"] > 0
    paged.alloc.check()
    assert paged.alloc.live_pages() == 0


def test_weight_bridge_round_trip(lm, tmp_path):
    """The reference's stacked 4-D leaves through its own checkpoint
    file: ``load_jax_npz`` + ``params_from_numpy`` give each layer's
    (E, D, F) slice bitwise, the shared MLP's too, and restacking the
    port's tensors gives the reference's arrays back."""
    _, pcfg, _, _, _, _, params = lm
    e, d, f = pcfg.n_experts, pcfg.d_model, pcfg.moe_d_ff
    save_tree(str(tmp_path / "ckpt"), params)
    flat = load_jax_npz(str(tmp_path / "ckpt"))
    assert flat["seg0/p0/ffn/w_gate"].shape == (2, e, d, f)
    sd = params_from_numpy(flat, pcfg, **CPU)
    assert tuple(sd["seg0.1.p0.ffn.w_up"].shape) == (e, d, f)
    assert tuple(sd["seg0.1.p0.ffn.shared.gate"].shape) == (d, f)
    sd = build_model(pcfg, params=sd, **CPU).state_dict()
    for path, a in tree_paths(params):
        if path.startswith("seg0/"):
            name = path[len("seg0/"):].replace("/", ".")
            back = np.stack([sd[f"seg0.{g}.{name}"].numpy()
                             for g in range(2)])
        else:
            back = sd[path.replace("/", ".")].numpy()
        np.testing.assert_array_equal(back, np.asarray(a), err_msg=path)
    stacked = sum(p.startswith("seg0/") for p, _ in tree_paths(params))
    assert len(sd) == len(tree_paths(params)) + stacked


def test_serve_cli_and_cuda_default(lm, capsys):
    """``launch.serve --arch qwen3-moe-30b-a3b --device cpu`` serves the
    reduced model; without CUDA the default device raises."""
    port_launch.main(["--arch", ARCH, "--device", "cpu", "--requests", "2",
                      "--max-new", "3"])
    assert "[serve] 2 requests, 6 tokens" in capsys.readouterr().out
    _, pcfg, _, _, pp, _, _ = lm
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            build_model(pcfg, params=pp)
        with pytest.raises(RuntimeError, match="CUDA"):
            pserve.TokenServer(pcfg, pp)
