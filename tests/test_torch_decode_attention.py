"""Port parity: single-token decode attention (``kernels/decode_attention``
and the decode half of ``models/attention.py``) against the JAX
reference on the host.

The same inputs, made with numpy from a seed, go through both packages.
The reference's fused op runs as its own tests run it off-TPU: through
its plain twin (``use_kernel=False``), and once through the Pallas
kernel in interpret mode.  Bars: the attention output within 1e-5
(float32 sums taken in another order), the written caches bitwise (the
rotation is elementwise, so the rounded k/v must be identical).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.kernels import decode_attention as jax_decode_attention  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro_torch.checkpoint import params_from_numpy  # noqa: E402
from repro_torch.configs import get_arch, reduced  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_ref, kernel)
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import build_model, layers  # noqa: E402

ATOL = 1e-5


def _inputs(seed, b=3, hq=4, hkv=2, s=16, hd=8):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    return (f(b, hq, 1, hd), f(b, hkv, 1, hd), f(b, hkv, 1, hd),
            f(b, hkv, s, hd), f(b, hkv, s, hd))


def _both(arrays, pos, cache_dtype="bfloat16", jax_kw=None, **kw):
    """Run the reference op and the port's op on the same arrays; returns
    numpy (o, k, v) of each, caches as float32."""
    q, kn, vn, ck, cv = arrays
    jdt, tdt = getattr(jnp, cache_dtype), getattr(torch, cache_dtype)
    jo, jk, jv = jax_decode_attention(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
        jnp.asarray(ck, jdt), jnp.asarray(cv, jdt), jnp.asarray(pos),
        **kw, **(jax_kw or {"use_kernel": False}))
    t = torch.from_numpy
    po, pk, pv = decode_attention(t(q), t(kn), t(vn), t(ck).to(tdt),
                                  t(cv).to(tdt), t(pos), **kw)
    as_np = lambda a: np.asarray(jnp.asarray(a, jnp.float32))  # noqa: E731
    return ((np.asarray(jo), as_np(jk), as_np(jv)),
            (po.numpy(), pk.float().numpy(), pv.float().numpy()))


def _assert_match(ref, port):
    (jo, jk, jv), (po, pk, pv) = ref, port
    assert po.shape == jo.shape and po.dtype == np.float32
    np.testing.assert_allclose(po, jo, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(pk, jk)
    np.testing.assert_array_equal(pv, jv)


@pytest.mark.parametrize("kw", [
    {},                                        # linear mask, no rope
    {"rope_theta": 1e4},                       # fused rotation
    {"rope_theta": 1e6},                       # qwen2.5-3b's theta
    {"window": 6},                             # SWA ring mask
    {"rope_theta": 1e4, "window": 6},
    {"softcap": 30.0},
    {"write": False},                          # paged-gather variant
    {"rope_theta": 1e4, "softcap": 30.0, "write": False},
])
def test_decode_attention_matches_reference(kw):
    pos = np.asarray([3, 15, 0], np.int32)     # ragged, incl. edge rows
    _assert_match(*_both(_inputs(0), pos, **kw))


@pytest.mark.parametrize("hd,hq,hkv", [(64, 8, 1), (120, 4, 2), (128, 16, 2),
                                       (8, 2, 2)])
def test_decode_attention_head_dims_and_groups(hd, hq, hkv):
    """Any even head dim (read in place, no padding) and G in {1..16}."""
    pos = np.asarray([1, 9, 15], np.int32)
    _assert_match(*_both(_inputs(1, hq=hq, hkv=hkv, hd=hd), pos,
                         rope_theta=1e6))


@pytest.mark.parametrize("seed", [2, 3, 4])
def test_decode_attention_ring_wraparound(seed):
    """SWA ring with positions far past the slot count, ragged per row."""
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, 4 * 8, size=(3,)).astype(np.int32)
    pos[0] = 8 * 3 + 7                         # wrapped three times
    _assert_match(*_both(_inputs(seed, s=8), pos, window=5,
                         rope_theta=1e4))


@pytest.mark.parametrize("window", [0, 8])
def test_decode_attention_negative_position(window):
    """A row at pos = -1 writes nothing (the reference's one-hot select at
    slot rem(-1, S) = -1 matches no slot) and, every slot masked, gets
    the uniform mean of its S value rows; the other row is unaffected."""
    pos = np.asarray([-1, 3], np.int32)
    ref, port = _both(_inputs(11, b=2, s=16), pos, window=window,
                      rope_theta=1e4)
    _assert_match(ref, port)
    ck, cv = _inputs(11, b=2, s=16)[3:]
    ck, cv = (torch.from_numpy(a).to(torch.bfloat16).float()
              for a in (ck, cv))
    np.testing.assert_array_equal(port[1][0], ck[0].numpy())
    np.testing.assert_array_equal(port[2][0], cv[0].numpy())
    mean_v = cv[0].mean(dim=1)                            # (Hkv, hd)
    o = port[0][0].reshape(2, 2, 8)                       # (Hkv, G, hd)
    np.testing.assert_allclose(o, mean_v[:, None].expand(2, 2, 8).numpy(),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("axis", [1, 2])
def test_row_update_skips_slots_outside_the_cache(axis):
    """``row_update`` against the reference's one-hot select, with slots
    -1 and S among in-range ones."""
    rng = np.random.default_rng(12)
    shape = (4, 16, 8) if axis == 1 else (4, 2, 16, 8)
    cache = rng.normal(size=shape).astype(np.float32)
    new = np.expand_dims(np.delete(rng.normal(size=shape), np.s_[1:],
                                   axis=axis).squeeze(axis), axis)
    new = new.astype(np.float32)
    slot = np.asarray([-1, 3, 16, 15], np.int32)
    want = jax_attn.row_update(jnp.asarray(cache), jnp.asarray(new),
                               jnp.asarray(slot), axis=axis)
    got = attn.row_update(torch.from_numpy(cache.copy()),
                          torch.from_numpy(new), torch.from_numpy(slot),
                          axis=axis)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decode_attention_f32_cache():
    """With float32 caches the written k shows the rotation's own
    rounding: XLA's CPU fusion may contract x1*cos - x2*sin into an FMA,
    the port rounds each product (as the CUDA kernel does), so k agrees
    to 1 ulp; v, which is not rotated, bitwise."""
    pos = np.asarray([2, 7, 11], np.int32)
    (jo, jk, jv), (po, pk, pv) = _both(_inputs(5), pos,
                                       cache_dtype="float32", rope_theta=1e4)
    np.testing.assert_allclose(po, jo, atol=ATOL, rtol=0)
    np.testing.assert_array_less(np.abs(pk - jk),
                                 np.spacing(np.abs(jk)) * 1.0001 + 1e-30)
    np.testing.assert_array_equal(pv, jv)


def test_decode_attention_vs_reference_pallas_kernel_interpreted():
    """One case against the reference's Pallas kernel itself (interpret
    mode), not only its plain twin."""
    pos = np.asarray([3, 15, 0], np.int32)
    _assert_match(*_both(_inputs(6), pos, rope_theta=1e4, window=6,
                         jax_kw={"use_kernel": True, "interpret": True}))


def test_decode_attention_writes_in_place():
    q, kn, vn, ck, cv = (torch.from_numpy(a) for a in _inputs(7))
    ck, cv = ck.to(torch.bfloat16), cv.to(torch.bfloat16)
    pos = torch.tensor([3, 15, 0], dtype=torch.int32)
    before = ck.clone()
    _, k2, v2 = decode_attention(q, kn, vn, ck, cv, pos)
    assert k2 is ck and v2 is cv
    changed = (ck != before).any(dim=-1)       # (B, Hkv, S)
    for b, p in enumerate([3, 15, 0]):
        assert changed[b, :, p].all()
        assert not changed[b, :, [j for j in range(16) if j != p]].any()
    _, k3, _ = decode_attention(q, kn, vn, ck, cv, pos, write=False)
    assert torch.equal(k3, ck)


def test_dispatch_and_kernel_binding_checks():
    """On a CPU tensor the op is its plain version; asking for the kernel
    there, or handing the binding host tensors, raises (no fallback)."""
    q, kn, vn, ck, cv = (torch.from_numpy(a) for a in _inputs(8))
    pos = torch.tensor([1, 2, 3], dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention(q, kn, vn, ck, cv, pos, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.decode_attention_tiles(
            q.reshape(3, 2, 2, 8), kn[:, :, 0], vn[:, :, 0], ck, cv, pos,
            None, None, window=0, scale=0.35, softcap=0.0, write=True)
    a = decode_attention(q, kn, vn, ck.clone(), cv.clone(), pos)
    b = decode_attention_ref(q, kn, vn, ck.clone(), cv.clone(), pos)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("window", [0, 3, 5])
def test_decode_slot_validity_matches_reference(window):
    pos = np.asarray([0, 2, 6, 13, 40], np.int32)
    j = np.asarray(jax_attn.decode_slot_validity(jnp.asarray(pos), 8,
                                                 window=window))
    p = attn.decode_slot_validity(torch.from_numpy(pos), 8, window=window)
    np.testing.assert_array_equal(p.numpy(), j)
    j0 = np.asarray(jax_attn.decode_slot_validity(jnp.int32(5), 8,
                                                  window=window))
    p0 = attn.decode_slot_validity(torch.tensor(5, dtype=torch.int32), 8,
                                   window=window)
    np.testing.assert_array_equal(p0.numpy(), j0)


def test_rope_tables_and_rotation_match_reference():
    pos = np.asarray([0, 1, 7, 511, 100_000], np.int32)
    jc, js = jax.device_get(jax_layers.rope_tables(jnp.asarray(pos), 128,
                                                   1e6))
    pc, ps = layers.rope_tables(torch.from_numpy(pos), 128, 1e6)
    np.testing.assert_allclose(pc.numpy(), jc, atol=2e-7, rtol=0)
    np.testing.assert_allclose(ps.numpy(), js, atol=2e-7, rtol=0)
    x = np.random.default_rng(9).normal(size=(5, 3, 128)).astype(np.float32)
    jr = np.asarray(jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pc)[:, None],
                                          jnp.asarray(ps)[:, None]))
    pr = layers.apply_rope(torch.from_numpy(x), pc[:, None], ps[:, None])
    np.testing.assert_array_equal(pr.numpy(), jr)


@pytest.fixture(scope="module")
def attn_pair():
    """qwen2.5-3b reduced: one layer's attention params in both packages,
    with non-zero QKV biases."""
    jcfg = jax_reduced(jax_get_arch("qwen2.5-3b"))
    pcfg = reduced(get_arch("qwen2.5-3b"))
    jp = jax.device_get(jax_build_model(jcfg).init(jax.random.key(0)))
    rng = np.random.default_rng(10)
    mixer = jp["seg0"]["p0"]["mixer"]
    for k in ("bq", "bk", "bv"):
        mixer[k] = (0.1 * rng.normal(size=mixer[k].shape)).astype(np.float32)
    pp = params_from_numpy(jp, pcfg, device="cpu")
    jap = jax.tree_util.tree_map(lambda a: a[0], mixer)
    pap = {k.split(".")[-1]: v for k, v in pp.items()
           if k.startswith("seg0.0.p0.mixer.")}
    return jcfg, pcfg, jap, pap


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("per_row", [True, False])
def test_attention_decode_matches_reference(attn_pair, use_kernel, per_row):
    """The model-level decode tail (projections + RoPE + ring write +
    masked softmax·V + output projection), per-row and lockstep."""
    jcfg, pcfg, jap, pap = attn_pair
    spec = pcfg.segments[0].pattern[0]
    rng = np.random.default_rng(11)
    b, s, hkv, hd = 4, 32, pcfg.n_kv_heads, pcfg.resolved_head_dim
    x = rng.normal(size=(b, 1, pcfg.d_model)).astype(np.float32)
    ck = rng.normal(size=(b, hkv, s, hd)).astype(np.float32)
    cv = rng.normal(size=(b, hkv, s, hd)).astype(np.float32)
    pos = (np.asarray([3, 7, 2, 9], np.int32) if per_row
           else np.asarray(6, np.int32))
    jo, jc = jax_attn.attention_decode(
        jap, jcfg, jcfg.segments[0].pattern[0], jnp.asarray(x),
        {"k": jnp.asarray(ck, jnp.bfloat16), "v": jnp.asarray(cv, jnp.bfloat16)},
        jnp.asarray(pos), use_kernel=use_kernel)
    cache = {"k": torch.from_numpy(ck).to(torch.bfloat16),
             "v": torch.from_numpy(cv).to(torch.bfloat16)}
    po, pc = attn.attention_decode(pap, pcfg, spec, torch.from_numpy(x),
                                   cache, torch.from_numpy(pos),
                                   use_kernel=use_kernel)
    assert pc is cache
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=ATOL, rtol=0)
    for k in ("k", "v"):
        np.testing.assert_array_equal(
            pc[k].float().numpy(), np.asarray(jc[k].astype(jnp.float32)))


def test_fused_and_plain_tails_are_bitwise_equal_on_the_host(attn_pair):
    """On the host the fused op is the plain tail's own arithmetic."""
    _, pcfg, _, pap = attn_pair
    spec = pcfg.segments[0].pattern[0]
    g = torch.Generator().manual_seed(12)
    x = torch.randn((4, 1, pcfg.d_model), generator=g)
    ck = torch.randn((4, 2, 16, 64), generator=g).to(torch.bfloat16)
    pos = torch.tensor([0, 5, 15, 8], dtype=torch.int32)
    outs = []
    for use_kernel in (False, True):
        cache = {"k": ck.clone(), "v": ck.clone()}
        o, c = attn.attention_decode(pap, pcfg, spec, x, cache, pos,
                                     use_kernel=use_kernel)
        outs.append((o, c["k"], c["v"]))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_unported_attention_paths_raise(attn_pair):
    _, pcfg, _, pap = attn_pair
    spec = pcfg.segments[0].pattern[0]
    with pytest.raises(NotImplementedError, match="paged"):
        attn.init_attn_cache(pcfg, spec, 2, 8, torch.bfloat16,
                             paging=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="paged"):
        attn.attention_decode(pap, pcfg, spec, torch.zeros((1, 1, 256)),
                              {"k": torch.zeros((8, 2, 64)),
                               "v": torch.zeros((8, 2, 64))},
                              torch.zeros((1,), dtype=torch.int32))


# ------------------------------------------- per-step RoPE tables, split plan

@pytest.mark.parametrize("kw", [
    {"rope_theta": 1e6},
    {"rope_theta": 1e4, "window": 6},
    {"rope_theta": 1e4, "softcap": 30.0},
    {"rope_theta": 1e6, "write": False},
])
@pytest.mark.parametrize("cache_dtype", [torch.bfloat16, torch.float32])
def test_rope_tables_passed_in_give_the_same_bits(kw, cache_dtype):
    """The tables a decode step computes once, passed to the fused op and
    to its plain version, give bitwise the o and caches of the tables
    computed inside the op."""
    q, kn, vn, ck, cv = (torch.from_numpy(a) for a in _inputs(13))
    ck, cv = ck.to(cache_dtype), cv.to(cache_dtype)
    pos = torch.tensor([3, 15, 0], dtype=torch.int32)
    tables = layers.rope_tables(pos, q.shape[-1], kw["rope_theta"])
    for fn in (decode_attention, decode_attention_ref):
        inside = fn(q, kn, vn, ck.clone(), cv.clone(), pos, **kw)
        given = fn(q, kn, vn, ck.clone(), cv.clone(), pos, **kw,
                   rope_tables=tables)
        for a, b in zip(inside, given):
            assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("bh,s,sms,want", [
    (32, 512, 132, 8),          # the serving shape: 16 rows x 2 kv heads
    (32, 1024, 132, 8),         # capped at MAX_SPLIT (one portable cluster)
    (32, 1000, 132, 8),
    (32, 40, 132, 1),           # S shorter than one tile
    (32, 64, 132, 1),
    (32, 65, 132, 2),
    (264, 512, 132, 1),         # B*Hkv fills the card alone
    (320, 4096, 132, 1),
    (200, 4096, 132, 2),
    (1, 32768, 132, 8),
])
def test_split_plan(bh, s, sms, want):
    n = kernel.split_plan(bh, s, sms)
    assert n == want and 1 <= n <= kernel.MAX_SPLIT


@pytest.mark.parametrize("window", [0, 5, 8, 20])
@pytest.mark.parametrize("slots", [8, 13])
def test_valid_slots_are_one_ring_interval(window, slots):
    """The kernel reads, per row, only the ring interval of
    n = min(pos + 1, S[, window]) slots ending at pos % S, split into
    nsplit chunks of ceil(n / nsplit); that interval is exactly the
    mask's valid set, and the chunk holding its last index (the one that
    writes the new token) holds slot pos % S."""
    for p in range(0, 4 * slots + 3):
        valid = attn.decode_slot_validity(torch.tensor(p), slots,
                                          window=window).numpy()
        n = min(p + 1, slots, window) if window else min(p + 1, slots)
        e = p % slots
        ring = [(e - n + 1 + i) % slots for i in range(n)]
        assert sorted(ring) == list(np.flatnonzero(valid)), p
        for nsplit in range(1, kernel.MAX_SPLIT + 1):
            chunk = -(-n // nsplit)
            spans = [(sp * chunk, min(sp * chunk + chunk, n))
                     for sp in range(nsplit)]
            covered = [i for i0, i1 in spans for i in range(i0, i1)]
            assert covered == list(range(n))
            writer = [sp for sp, (i0, i1) in enumerate(spans)
                      if i0 < i1 and i1 == n]
            assert len(writer) == 1 and ring[spans[writer[0]][1] - 1] == e
