"""Port parity: causal sliding-window attention
(``kernels/swa_attention``: the plain version ``ref.py`` and the op's
host route) against the JAX reference's ``swa_attention_ref`` and its
Pallas kernel in interpret mode.

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

import jax.numpy as jnp  # noqa: E402

from repro.kernels.swa_attention import swa_attention as jax_swa  # noqa: E402
from repro.kernels.swa_attention import swa_attention_ref as jax_ref  # noqa: E402
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
    """On a CUDA tensor the op runs the kernel, which has no backward:
    under autograd it raises before launching.  The guard is checked on
    host tensors; the dispatch refuses the kernel for them."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 1, 16, 8, 3))
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.check_no_autograd(q, k.requires_grad_(True), v)
    with torch.inference_mode():
        ops.check_no_autograd(q, k, v)
    with torch.no_grad():
        ops.check_no_autograd(q, k, v)
    k.requires_grad_(False)
    ops.check_no_autograd(q, k, v)
    with pytest.raises(ValueError, match="CUDA tensor"):
        swa_attention(q, k, v, 4, use_kernel=True)
    with pytest.raises(ValueError, match="window"):
        swa_attention(q, k, v, 0)
    # the host route is the plain version, differentiable, no library
    qq = q.clone().requires_grad_(True)
    swa_attention(qq, k, v, 4).sum().backward()
    assert qq.grad is not None and bool(torch.isfinite(qq.grad).all())
    assert "swa_attention" not in _build._LIBS


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
