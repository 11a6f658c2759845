"""Port parity: causal sliding-window attention
(``kernels/swa_attention``: the plain version ``ref.py`` and the op's
host route) against the JAX reference's ``swa_attention_ref`` and its
Pallas kernel in interpret mode; the op's autograd function (its chunked
backward) against XLA's gradients of the reference's plain branches,
explicit positions included.

The same seeded numpy inputs go through both packages.  Bars: within
1e-5 of max(1, |ref|) in f32; with bf16 inputs the same 1e-5, since both
sides widen the same bf16 values to f32 and compute in f32 (the Pallas
kernel alone rounds its rescaled q to bf16, so against it the bf16 bar
is the reference's own 3e-2).  The Hopper kernel itself is held against
the plain version on the card by ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.swa_attention import swa_attention as jax_swa  # noqa: E402
from repro.kernels.swa_attention import swa_attention_ref as jax_ref  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro_torch.kernels import _build, _tf32  # noqa: E402
from repro_torch.kernels.swa_attention import (  # noqa: E402
    swa_attention, swa_attention_ref)
from repro_torch.kernels.swa_attention import ops, ref  # noqa: E402

REL = 1e-5


def _rel(a, ref):
    return float((np.abs(a - ref) / np.maximum(1.0, np.abs(ref))).max())


def _inputs(b, hq, hkv, s, hd, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(b, hq, s, hd)) * scale).astype(np.float32)
    k = rng.normal(size=(b, hkv, s, hd)).astype(np.float32)
    v = rng.normal(size=(b, hkv, s, hd)).astype(np.float32)
    return q, k, v


def _jax_gqa_ref(q, k, v, window, softcap=0.0):
    g = q.shape[1] // k.shape[1]
    return np.asarray(jax_ref(jnp.asarray(q), jnp.repeat(jnp.asarray(k), g, 1),
                              jnp.repeat(jnp.asarray(v), g, 1), window,
                              softcap=softcap))


CASES = [  # b, hq, hkv, s, hd, window
    (2, 2, 2, 64, 32, 16),          # the reference's tiny case
    (1, 4, 2, 96, 80, 33),          # GQA 2, window not a tile multiple
    (1, 4, 1, 300, 120, 100),       # GQA 4, S unaligned
    (2, 4, 4, 128, 32, 128),        # window == S: causal
    (1, 2, 1, 200, 80, 4096),       # window > S: causal
    (1, 8, 2, 130, 120, 64),        # GQA 4 at danube's head dim
]


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("b,hq,hkv,s,hd,window", CASES)
def test_ref_and_op_match_reference(b, hq, hkv, s, hd, window, softcap):
    # q scaled so that a softcap of 30 bends the larger scores
    q, k, v = _inputs(b, hq, hkv, s, hd, s + window, scale=2.0)
    want = _jax_gqa_ref(q, k, v, window, softcap)
    g = hq // hkv
    t = torch.from_numpy
    ref = swa_attention_ref(t(q), t(k).repeat_interleave(g, 1),
                            t(v).repeat_interleave(g, 1), window,
                            softcap=softcap)
    op = swa_attention(t(q), t(k), t(v), window, softcap=softcap)
    for got in (ref, op):
        assert got.shape == (b, hq, s, hd) and got.dtype == torch.float32
        assert _rel(got.numpy(), want) <= REL


def test_bf16_inputs_match_reference():
    q, k, v = _inputs(1, 4, 2, 128, 64, 11)
    qb, kb, vb = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(jax_ref(qb, jnp.repeat(kb, 2, 1), jnp.repeat(vb, 2, 1),
                              48))
    tb = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16) for a in (qb, kb, vb)]
    got = swa_attention(*tb, 48)
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= REL


@pytest.mark.parametrize("b,hq,hkv,s,hd,window", [(2, 2, 2, 64, 32, 16),
                                                  (1, 4, 2, 48, 80, 20)])
def test_op_matches_pallas_interpret(b, hq, hkv, s, hd, window):
    """The reference's kernel itself (interpret mode), GQA repeated and
    hd padded to 128 lanes in its wrapper."""
    q, k, v = _inputs(b, hq, hkv, s, hd, 7 + s)
    want = np.asarray(jax_swa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              window, interpret=True))
    got = swa_attention(*(torch.from_numpy(a) for a in (q, k, v)), window)
    assert _rel(got.numpy(), want) <= REL


def test_window_locality_property():
    """Keys and values beyond the window of the last query change none
    of its output, bitwise (their scores are masked before the
    softmax)."""
    rng = np.random.default_rng(12)
    s, w = 256, 64
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 2, s, 32)).astype(
        np.float32)) for _ in range(3))
    o1 = swa_attention(q, k, v, w)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, :s - w] = torch.from_numpy(rng.normal(size=(1, 2, s - w, 32))
                                        .astype(np.float32))
    v2[:, :, :s - w] = torch.from_numpy(rng.normal(size=(1, 2, s - w, 32))
                                        .astype(np.float32))
    o2 = swa_attention(q, k2, v2, w)
    assert torch.equal(o1[:, :, -1], o2[:, :, -1])
    assert not torch.equal(o1[:, :, s - w], o2[:, :, s - w])


def test_autograd_guard_and_dispatch_rules():
    """Under autograd the op is its autograd function (kernel forward on
    the card, the plain version here; the chunked backward on both): its
    gradients equal autograd through the plain version, and the
    function is taken only when a gradient is wanted.  The dispatch
    refuses the kernel for host tensors, a window below 1 and positions
    with a window below S."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 1, 16, 8, 3))
    with pytest.raises(ValueError, match="CUDA tensor"):
        swa_attention(q, k, v, 4, use_kernel=True)
    with pytest.raises(ValueError, match="window"):
        swa_attention(q, k, v, 0)
    with pytest.raises(ValueError, match="causal branch"):
        swa_attention(q, k, v, 4, positions=torch.arange(16))
    with pytest.raises(ValueError, match="positions"):
        swa_attention(q, k, v, 16, positions=torch.arange(15))
    assert swa_attention(q, k, v, 4).grad_fn is None
    qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
    o = swa_attention(qq, kk, vv, 4)
    assert type(o.grad_fn).__name__ == "_SwaAttentionBackward"
    do = torch.from_numpy(np.random.default_rng(4).normal(
        size=o.shape).astype(np.float32))
    got = torch.autograd.grad(o, (qq, kk, vv), do)
    plain = swa_attention_ref(qq, kk.repeat_interleave(2, 1),
                              vv.repeat_interleave(2, 1), 4)
    want = torch.autograd.grad(plain, (qq, kk, vv), do)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w.numpy()) <= REL
    assert "swa_attention" not in _build._LIBS


def _jax_twin_grads(q, k, v, do, window, softcap, pos):
    """o and (dq, dk, dv) of the reference's own branch, by XLA's
    autodiff: ``flash_full_attention`` at ``pos`` (causal) or
    ``windowed_attention`` (window < S), q grouped (B,Hkv,G,S,hd)."""
    b, hq, s, hd = q.shape
    hkv = k.shape[1]

    def f(q, k, v):
        qg = q.reshape(b, hkv, hq // hkv, s, hd)
        if window < s:
            o = jax_attn.windowed_attention(qg, k, v, 0, window,
                                            attn_softcap=softcap)
        else:
            o = jax_attn.flash_full_attention(qg, k, v, pos, pos,
                                              attn_softcap=softcap)
        return o.reshape(q.shape)
    o, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    return np.asarray(o), [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("b,hq,hkv,s,hd,window,softcap,pos", [
    (2, 4, 2, 100, 16, 100, 0.0, "arange"),      # causal
    (1, 4, 1, 160, 32, 48, 30.0, "arange"),      # banded, GQA 4, softcap
    (1, 4, 2, 70, 16, 70, 30.0, "shifted"),      # positions, no-key rows
    (1, 2, 2, 300, 8, 512, 0.0, "shuffled"),     # positions out of order
])
def test_backward_matches_reference_autodiff(b, hq, hkv, s, hd, window,
                                             softcap, pos):
    """The op under autograd (the host forward, the chunked backward over
    several 128-row chunks) against XLA's gradients of the reference's
    plain branch on the same inputs, GQA summed over each kv head's G
    query heads: o, dq, dk and dv within 1e-5 of max(1, |reference|)."""
    q, k, v = _inputs(b, hq, hkv, s, hd, 20 + s, scale=2.0)
    rng = np.random.default_rng(s)
    do = rng.normal(size=q.shape).astype(np.float32)
    p = np.arange(s, dtype=np.int32)
    if pos == "shifted":
        p = p + 7
        p[[2, 40]] = -3
    elif pos == "shuffled":
        p = rng.permutation(s).astype(np.int32) - 5
    o_ref, g_ref = _jax_twin_grads(q, k, v, do, window, softcap, p)
    t = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    o = swa_attention(*t, window, softcap=softcap,
                      positions=None if pos == "arange"
                      else torch.from_numpy(p))
    got = torch.autograd.grad(o, t, torch.from_numpy(do))
    assert _rel(o.detach().numpy(), o_ref) <= REL
    for g, w in zip(got, g_ref):
        assert g.shape == w.shape and _rel(g.numpy(), w) <= REL


@pytest.mark.parametrize("s", [1024, 1100])
def test_rows_that_see_no_key(s):
    """A negative position sees no key: the reference's finite -1e30
    mask makes its row the sum of v over the padded key count, S rounded
    up to its 1,024-key chunk (S under ``attn_whole_seq``), and the plain
    version (the kernel's function) the mean over the S keys.  At S =
    1,024 the two agree; at 1,100 they differ by the factor 1,100 /
    2,048 (ROADMAP, "Differences on purpose").  Every other row agrees
    with the reference, and a seen row's gradient too."""
    q, k, v = _inputs(1, 2, 1, s, 8, 30 + s)
    p = np.arange(s, dtype=np.int32) + 3
    p[[0, 500]] = -1
    o_ref, _ = _jax_twin_grads(q, k, v, np.zeros_like(q), s, 0.0, p)
    o = swa_attention(*(torch.from_numpy(a) for a in (q, k, v)), s,
                      positions=torch.from_numpy(p)).numpy()
    seen = p >= 0
    assert _rel(o[:, :, seen], o_ref[:, :, seen]) <= REL
    mean = v.mean(axis=2, keepdims=True)                    # (1,1,1,hd)
    assert _rel(o[:, :, ~seen], np.broadcast_to(mean, o[:, :, ~seen].shape)
                ) <= REL
    padded = -(-s // 1024) * 1024
    assert _rel(o_ref[:, :, ~seen], np.broadcast_to(
        mean * s / padded, o_ref[:, :, ~seen].shape)) <= REL
    assert (s % 1024 == 0) == (_rel(o[:, :, ~seen], o_ref[:, :, ~seen])
                               <= REL)


def test_tiled_twin_with_positions_matches_plain():
    """The kernel's schedule on the host with positions (every key tile,
    the last tile's keys past S at -inf) against the plain version, at
    the tile widths of hd 64 and 256 and S past a tile edge."""
    for hd, s in ((40, 150), (200, 45)):
        q, k, v = _inputs(1, 4, 2, s, hd, hd)
        p = torch.from_numpy((np.arange(s) + 5).astype(np.int32))
        p[[1, s - 3]] = -2
        t = [torch.from_numpy(a) for a in (q, k, v)]
        got = ref.swa_attention_tiled_ref(*t, s, positions=p)
        want = swa_attention(*t, s, positions=p)
        assert _rel(got.numpy(), want.numpy()) <= REL


# ------------------------------------ the kernel's arithmetic on the host

def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("x,want", [
    (0.0, 0.0), (-0.0, -0.0),
    (1.0, 1.0),
    (1 + 2.0**-11, 1 + 2.0**-10),              # a tie: away from zero
    (-(1 + 2.0**-11), -(1 + 2.0**-10)),
    (1 + 2.0**-11 - 2.0**-23, 1.0),            # below the tie: down
    (2 - 2.0**-12, 2.0),                       # up across a power of two
    (-(2 - 2.0**-12), -2.0),
    (np.inf, np.inf), (-np.inf, -np.inf),
    (2.0**-149 * 11192, 2.0**-149 * 8192),     # subnormal, rounded down
    (2.0**-149 * 3000, 0.0),                   # ... to zero
    (2.0**-149 * (2**23 - 1), 2.0**-126),      # subnormal up to a normal
    (float(np.finfo(np.float32).max), np.inf),
])
def test_tf32_rna_on_the_float_bits(x, want):
    got = _tf32.tf32_rna(torch.tensor([x], dtype=torch.float32)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits([want]))


def test_tf32_rna_nan_and_low_bits():
    x = torch.tensor([float("nan"), -float("nan")])
    assert bool(torch.isnan(_tf32.tf32_rna(x)).all())
    rng = np.random.default_rng(21)
    v = (rng.normal(size=4096) * np.exp2(rng.integers(-140, 120, 4096))
         ).astype(np.float32)
    big = _tf32.tf32_rna(torch.from_numpy(v)).numpy()
    assert not (_bits(big) & 0x1FFF).any()
    # round to nearest: within half a TF32 unit (2^-10 of the binade) for
    # normal values
    ok = np.isfinite(big) & (np.abs(v) >= np.finfo(np.float32).tiny)
    a = np.abs(v[ok]).astype(np.float64)
    unit = np.exp2(np.floor(np.log2(a)) - 10)
    assert (np.abs(big[ok].astype(np.float64) - v[ok]) <= unit / 2).all()


def test_tf32_split_reproduces_x():
    """big + small is x to 2^-22 of |x| (normal range), and both halves
    are TF32 values."""
    rng = np.random.default_rng(22)
    v = (rng.normal(size=8192) * np.exp2(rng.integers(-100, 100, 8192))
         ).astype(np.float32)
    big, small = _tf32.tf32_split(torch.from_numpy(v))
    for h in (big, small):
        assert not (_bits(h.numpy()) & 0x1FFF).any()
    err = np.abs(big.numpy().astype(np.float64) + small.numpy() - v)
    assert (err <= np.abs(v) * 2.0**-22).all()


@pytest.mark.parametrize("hd,want", [(1, 64), (64, 64), (65, 120),
                                     (100, 120), (120, 120), (121, 128),
                                     (128, 128), (129, 256), (256, 256)])
def test_padded_head_dim(hd, want):
    assert ref.padded_head_dim(hd) == want
    assert want % 8 == 0 and ref.TILES[want] % 8 == 0


TWIN_CASES = CASES + [(1, 4, 2, 150, 100, 64),     # hd = 100: padded to 120
                      (1, 2, 2, 96, 100, 200)]


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("b,hq,hkv,s,hd,window", TWIN_CASES)
def test_tiled_twin_matches_reference(b, hq, hkv, s, hd, window, softcap):
    """The kernel's schedule with its 3xTF32 products meets the float32
    bar against the reference."""
    q, k, v = _inputs(b, hq, hkv, s, hd, s + window, scale=2.0)
    want = _jax_gqa_ref(q, k, v, window, softcap)
    got = ref.swa_attention_tiled_ref(*(torch.from_numpy(a)
                                        for a in (q, k, v)), window,
                                      softcap=softcap)
    assert got.shape == (b, hq, s, hd) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= REL


@pytest.mark.parametrize("b,hq,hkv,s,hd,window", [(2, 2, 2, 64, 32, 16),
                                                  (1, 4, 2, 48, 80, 20),
                                                  (1, 2, 1, 40, 100, 9)])
def test_tiled_twin_matches_pallas_interpret(b, hq, hkv, s, hd, window):
    q, k, v = _inputs(b, hq, hkv, s, hd, 9 + s)
    want = np.asarray(jax_swa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              window, interpret=True))
    got = ref.swa_attention_tiled_ref(*(torch.from_numpy(a)
                                        for a in (q, k, v)), window)
    assert _rel(got.numpy(), want) <= REL


def test_tiled_twin_reads_nothing_before_the_band():
    """NaN keys and values before the band of the last query tile change
    none of its rows, bitwise: the band's first tile zeroes v there."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 1, 200, 64, 23))
    w = 50
    q0 = (200 - 1) // ref.Q_TILE * ref.Q_TILE
    o1 = ref.swa_attention_tiled_ref(q, k, v, w)
    k[:, :, :q0 - w + 1] = float("nan")
    v[:, :, :q0 - w + 1] = float("nan")
    o2 = ref.swa_attention_tiled_ref(q, k, v, w)
    assert torch.equal(o1[:, :, q0:], o2[:, :, q0:])
