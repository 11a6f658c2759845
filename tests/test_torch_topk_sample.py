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
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import topk_sample as jax_topk_sample  # noqa: E402
from repro.kernels.topk_sample import gumbel_rows as jax_gumbel_rows  # noqa: E402
from repro.kernels.topk_sample import topk_sample_ref as jax_topk_sample_ref  # noqa: E402
from repro.serve.sampling import sample_tokens as jax_sample_tokens  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.topk_logits.ref import (tile_width,  # noqa: E402
                                                 topk_logits_ref,
                                                 topk_logits_tiles_ref)
from repro_torch.kernels.topk_sample import (K_CAP_DEFAULT, gumbel_rows,  # noqa: E402
                                             kernel, topk_sample,
                                             topk_sample_ref)
from repro_torch.kernels.topk_sample.ref import merge_runs_ref, order_key  # noqa: E402
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
    # the merge's precondition: whole runs of k_cap, checked first
    with pytest.raises(ValueError, match="not a multiple of k_cap"):
        kernel.topk_sample_tiles(torch.zeros((2, 70)),
                                 torch.zeros((2, 70), dtype=torch.int32),
                                 None, None, None, None, k_cap=32,
                                 greedy=True)
    assert "topk_sample" not in _build._LIBS
    assert K_CAP_DEFAULT == 32


# (V, k_cap, raises): the candidates stage 1 hands stage 2 (ceil(V /
# 2,048) runs of k_cap) against the kernel's limit of 8,192: gemma3's
# 262,144 (128 runs, every run in a warp's registers), one past it (129),
# 524,288 (256 runs, C = 8,192), one tile more (C = 8,224), and 2,048 runs
# of 4; k_cap past 32 or past C
DOMAIN = [(262_144, 32, False), (262_145, 32, False), (524_288, 32, False),
          (524_289, 32, True), (4_194_304, 4, False), (4_194_305, 4, True),
          (20, 20, False), (66, 33, True)]


@pytest.mark.parametrize("v,k,raises", DOMAIN)
def test_wrapper_takes_the_kernels_domain(v, k, raises):
    """C <= 8,192 and k_cap <= min(C, 32) (as the earlier design took
    them), checked on the host before the device and before a kernel is
    loaded: inside it a CPU tensor is refused for being on the CPU."""
    c = -(-v // tile_width(v)) * k
    cv = torch.zeros((1, c))
    ci = torch.zeros((1, c), dtype=torch.int32)
    match = "C <= 8192" if raises else "CUDA"
    with pytest.raises(ValueError, match=match):
        kernel.topk_sample_tiles(cv, ci, None, None, None, None, k_cap=k,
                                 greedy=True)
    assert "topk_sample" not in _build._LIBS


def test_wrapper_limits_are_the_kernels():
    src = (Path(kernel.__file__).parents[1] / "csrc"
           / "topk_sample.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
    assert kernel.MAX_K == const("kMaxK") == K_CAP_DEFAULT
    assert kernel.MAX_CANDIDATES == const("kMaxCandidates")
    # the stage-1 candidates of gemma3's vocab fit in registers
    assert -(-262_144 // tile_width(262_144)) == 32 * const("kHot")


# ------------------------------------------- the kernel's merge on the host

def _merge_logits(kind, b, v, seed):
    """(B, V) f32 logits: continuous, tie-heavy, or all ±0 but a few."""
    rng = np.random.default_rng(seed)
    if kind == "continuous":
        return (rng.normal(size=(b, v)) * 3).astype(np.float32)
    if kind == "ties":
        return (np.round(rng.normal(size=(b, v)) * 2) / 2).astype(np.float32)
    lg = np.where(rng.random((b, v)) < 0.5, np.float32(-0.0),
                  np.float32(0.0)).astype(np.float32)
    few = rng.choice(v, size=max(1, v // 50), replace=False)
    lg[:, few] = rng.normal(size=(b, few.size)).astype(np.float32)
    return lg


MERGE_CASES = [(kind, v) for v in (20, 97, 300, 4100)
               for kind in ("continuous", "ties", "zeros")]


@pytest.mark.parametrize("kind,v", MERGE_CASES)
def test_merge_runs_is_the_rows_top_k_bitwise(kind, v):
    """V < k_cap (20), one short tile (97), a short last tile (300) and
    several 2,048-column tiles (4,100): the run-head merge of stage 1's
    candidates equals the row's top-k_cap bitwise, sign bits included."""
    x = torch.from_numpy(_merge_logits(kind, 6, v, v))
    k = min(K_CAP_DEFAULT, v)
    cv, ci = topk_logits_tiles_ref(x, k, tile_width(v))
    mv, mi = merge_runs_ref(cv, ci, k)
    rv, ri = topk_logits_ref(x, k)
    assert torch.equal(mv.view(torch.int32), rv.view(torch.int32))
    assert torch.equal(mi, ri) and mi.dtype == torch.int32


@pytest.mark.parametrize("kind,v", MERGE_CASES)
def test_merge_runs_matches_pallas_interpret(kind, v):
    """The same merge against the reference's fused sampler, its Pallas
    kernels run in interpret mode: vals (as numbers) and idx equal."""
    lg = _merge_logits(kind, 4, v, v + 1)
    x = torch.from_numpy(lg)
    k = min(K_CAP_DEFAULT, v)
    cv, ci = topk_logits_tiles_ref(x, k, tile_width(v))
    mv, mi = merge_runs_ref(cv, ci, k)
    jv, ji, _ = jax_topk_sample(jnp.asarray(lg), greedy=True,
                                use_kernel=True, interpret=True)
    np.testing.assert_array_equal(mv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(mi.numpy(), np.asarray(ji))


def test_merge_runs_order_key_and_precondition():
    vals = torch.tensor([-np.inf, -1.0, -0.0, 0.0, 1e-45, 2.0, np.inf])
    key = order_key(vals)
    assert bool((key[1:] >= key[:-1]).all()) and int(key[2]) == int(key[3])
    assert int(key.min()) > 0                   # 0 is the kernel's no-head
    # ±0 ties go in position order, each value keeps its sign bit
    cv = torch.tensor([[-0.0, -1.0, 0.0, -2.0]])
    mv, mi = merge_runs_ref(cv, torch.tensor([[7, 8, 9, 10]],
                                             dtype=torch.int32), 2)
    assert mi.tolist() == [[7, 9]]
    assert mv.view(torch.int32).tolist() == \
        cv[:, [0, 2]].view(torch.int32).tolist()
    with pytest.raises(ValueError, match="multiple"):
        merge_runs_ref(cv[:, :3], cv[:, :3].int(), 2)


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
