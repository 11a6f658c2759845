"""Port parity: the fused top-k/top-p Gumbel sampler
(``kernels/topk_sample``), the full-vocab sampler
(``serve/sampling.sample_tokens``) and the threefry twin behind both
(``utils/threefry.py``), against the JAX reference on the host.

Bars:
  * fed the reference's own Gumbel array, the plain sampler equals the
    reference's: vals and idx bitwise, tokens exact;
  * the threefry twin's bits equal ``jax.random.bits`` under ``fold_in``
    bitwise, its uniforms bitwise, its Gumbel noise within the last bit
    of the two ``log`` calls (2**-23 absolute + 2 ulp of the value:
    torch's and XLA's float32 ``log`` may differ in the last place);
  * on their own seeds (each package drawing its own noise) the samplers
    pick the same tokens.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import topk_sample as jax_topk_sample  # noqa: E402
from repro.kernels.topk_sample import gumbel_rows as jax_gumbel_rows  # noqa: E402
from repro.kernels.topk_sample import topk_sample_ref as jax_topk_sample_ref  # noqa: E402
from repro.serve.sampling import sample_tokens as jax_sample_tokens  # noqa: E402
from repro_torch.kernels.topk_sample import (K_CAP_DEFAULT, gumbel_rows,  # noqa: E402
                                             kernel, topk_sample,
                                             topk_sample_ref)
from repro_torch.serve.sampling import SamplingParams, sample_tokens  # noqa: E402
from repro_torch.utils import threefry  # noqa: E402

SEEDS = np.asarray([0, 1, 7, -5, 2**31 - 1, 123456, -2**31], np.int32)
POS = np.asarray([0, 3, 100, 7, 2**20, 5, 2**31 - 1], np.int32)


def _knobs(rng, b):
    return (rng.uniform(0.2, 1.5, b).astype(np.float32),
            rng.integers(0, 40, b).astype(np.int32),
            rng.uniform(0.3, 1.0, b).astype(np.float32),
            rng.integers(-2**31, 2**31 - 1, b).astype(np.int32),
            rng.integers(0, 4096, b).astype(np.int32))


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# ------------------------------------------------------------ threefry twin

def test_threefry_bits_equal_jax_bitwise():
    n = 1000

    def bits(s, p):
        key = jax.random.fold_in(jax.random.PRNGKey(s), p)
        return jax.random.bits(key, (n,), jnp.uint32)
    jb = np.asarray(jax.vmap(bits)(jnp.asarray(SEEDS), jnp.asarray(POS)))
    k1, k2 = threefry.fold_in(*_t(SEEDS, POS))
    pb = threefry.random_bits(k1, k2, n).numpy()
    np.testing.assert_array_equal(pb, jb.astype(np.int64))
    jk = np.stack([np.asarray(jax.random.key_data(jax.random.fold_in(
        jax.random.PRNGKey(s), p))) for s, p in zip(SEEDS, POS)])
    np.testing.assert_array_equal(torch.stack([k1, k2], 1).numpy(),
                                  jk.astype(np.int64))


def test_threefry_uniform_bitwise_and_gumbel_within_log_ulp():
    n = 4096
    tiny = np.finfo(np.float32).tiny

    def uni(s, p):
        key = jax.random.fold_in(jax.random.PRNGKey(s), p)
        return jax.random.uniform(key, (n,), jnp.float32, minval=tiny,
                                  maxval=1.0)

    def gum(s, p):
        key = jax.random.fold_in(jax.random.PRNGKey(s), p)
        return jax.random.gumbel(key, (n,), jnp.float32)
    ju = np.asarray(jax.vmap(uni)(jnp.asarray(SEEDS), jnp.asarray(POS)))
    jg = np.asarray(jax.vmap(gum)(jnp.asarray(SEEDS), jnp.asarray(POS)))
    seeds, pos = _t(SEEDS, POS)
    k1, k2 = threefry.fold_in(seeds, pos)
    pu = threefry.uniform(threefry.random_bits(k1, k2, n), threefry.TINY, 1.0)
    np.testing.assert_array_equal(pu.numpy(), ju)
    pg = threefry.gumbel(seeds, pos, n).numpy()
    assert pg.dtype == np.float32 and np.isfinite(pg).all()
    bound = 2.0 ** -23 + 2 * np.spacing(np.abs(jg))
    assert (np.abs(pg - jg) <= bound).all()


def test_gumbel_rows_match_reference_and_ignore_batch_composition():
    jg = np.asarray(jax_gumbel_rows(jnp.asarray(SEEDS), jnp.asarray(POS), 32))
    pg = gumbel_rows(*_t(SEEDS, POS), 32).numpy()
    assert (np.abs(pg - jg) <= 2.0 ** -23 + 2 * np.spacing(np.abs(jg))).all()
    solo = gumbel_rows(*_t(SEEDS[3:4], POS[3:4]), 32)
    assert torch.equal(solo[0], torch.from_numpy(pg[3]))
    shuffled = gumbel_rows(*_t(SEEDS[::-1], POS[::-1]), 32)
    assert torch.equal(shuffled.flip(0), torch.from_numpy(pg))


# ----------------------------------------------------------- fused sampler

@pytest.mark.parametrize("b,v,scale,ties", [(5, 300, 3.0, False),
                                            (16, 2048, 2.0, False),
                                            (8, 1000, 1.0, True),
                                            (3, 4100, 0.5, True)])
def test_topk_sample_ref_fed_reference_noise_matches_exactly(b, v, scale,
                                                             ties):
    rng = np.random.default_rng(b * v)
    lg = (rng.normal(size=(b, v)) * scale).astype(np.float32)
    if ties:
        lg = np.round(lg * 2) / 2
    temp, topk, topp, seeds, pos = _knobs(rng, b)
    temp[::3] = 0.0                          # greedy sentinel rows
    g = np.asarray(jax_gumbel_rows(jnp.asarray(seeds), jnp.asarray(pos), 32))
    jv, ji, jt = jax_topk_sample_ref(jnp.asarray(lg), jnp.asarray(temp),
                                     jnp.asarray(topk), jnp.asarray(topp),
                                     jnp.asarray(g), k_cap=32)
    pv, pi, pt = topk_sample_ref(*_t(lg, temp, topk, topp, g), k_cap=32)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    assert pi.dtype == torch.int32 and pt.dtype == torch.int32


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_topk_sample_matches_reference_on_its_own_seeds(seed):
    """Each package draws its own noise from (seed, pos): same tokens.
    The reference runs its Pallas kernel (interpret mode) once."""
    rng = np.random.default_rng(seed)
    b, v = 6, 700
    lg = (rng.normal(size=(b, v)) * 2).astype(np.float32)
    temp, topk, topp, seeds, pos = _knobs(rng, b)
    temp[0] = 0.0
    jargs = [jnp.asarray(a) for a in (lg, temp, topk, topp, seeds, pos)]
    jv, ji, jt = jax_topk_sample(*jargs, use_kernel=seed == 0,
                                 interpret=True)
    pv, pi, pt = topk_sample(*_t(lg, temp, topk, topp, seeds, pos))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))


def test_topk_sample_greedy_is_argmax_bitwise():
    rng = np.random.default_rng(3)
    lg = np.round(rng.normal(size=(9, 130)) * 2).astype(np.float32)  # ties
    vals, idx, tok = topk_sample(torch.from_numpy(lg), greedy=True)
    np.testing.assert_array_equal(tok.numpy(), np.argmax(lg, axis=1))
    jv, ji, jt = jax_topk_sample(jnp.asarray(lg), greedy=True,
                                 use_kernel=False)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def test_topk_sample_tiny_vocab():
    """V < k_cap clamps the candidate set."""
    rng = np.random.default_rng(4)
    lg = rng.normal(size=(3, 10)).astype(np.float32)
    temp, topk, topp, seeds, pos = _knobs(rng, 3)
    out = topk_sample(*_t(lg, temp, topk, topp, seeds, pos))
    ref = jax_topk_sample(*(jnp.asarray(a) for a in
                            (lg, temp, topk, topp, seeds, pos)),
                          use_kernel=False)
    assert out[0].shape == (3, 10)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    g = topk_sample(torch.from_numpy(lg), greedy=True)
    np.testing.assert_array_equal(g[2].numpy(), np.argmax(lg, axis=1))


def test_sampled_token_lies_in_the_kept_prefix():
    rng = np.random.default_rng(5)
    b = 32
    lg = torch.from_numpy((rng.normal(size=(b, 500)) * 2).astype(np.float32))
    temp, topk, topp, seeds, pos = _knobs(rng, b)
    topk = np.maximum(topk % 33, 1).astype(np.int32)
    _, idx, tok = topk_sample(lg, *_t(temp, topk, topp, seeds, pos))
    for r in range(b):
        assert int(tok[r]) in idx[r, :int(topk[r])].tolist()


def test_dispatch_and_binding_checks():
    lg = torch.zeros((2, 64))
    with pytest.raises(ValueError, match="CUDA"):
        topk_sample(lg, greedy=True, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.topk_sample_tiles(lg, torch.zeros((2, 64), dtype=torch.int32),
                                 None, None, None, None, k_cap=32,
                                 greedy=True)
    assert K_CAP_DEFAULT == 32


# -------------------------------------------------- full-vocab sampler

@pytest.mark.parametrize("seed", [0, 1])
def test_sample_tokens_matches_reference_on_its_own_seeds(seed):
    rng = np.random.default_rng(10 + seed)
    b, v = 8, 600
    lg = (rng.normal(size=(b, v)) * 2).astype(np.float32)
    temp, topk, topp, seeds, pos = _knobs(rng, b)
    temp[1] = 0.0
    topk[2] = 0                              # full vocabulary
    topk[3] = 300                            # wider than the fused set
    topp[4] = 1.0
    jt = jax_sample_tokens(*(jnp.asarray(a) for a in
                             (lg, temp, topk, topp, seeds, pos)))
    pt = sample_tokens(*_t(lg, temp, topk, topp, seeds, pos))
    assert pt.dtype == torch.int32
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    assert int(pt[1]) == int(np.argmax(lg[1]))


def test_sampling_params_validate():
    assert SamplingParams().greedy and not SamplingParams(0.5).greedy
    with pytest.raises(ValueError):
        SamplingParams(top_k=-1)
    with pytest.raises(ValueError):
        SamplingParams(top_p=0.0)
