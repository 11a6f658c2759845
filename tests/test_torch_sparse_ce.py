"""Port parity: the fused logsumexp + top-k gather (``sparse_ce``).

On the CPU the port's autograd function runs the full-logit plain
version forward and the chunked recompute backward; the reference runs
its Pallas kernel in interpret mode (forward) under its custom_vjp, and
its full-logit jnp ref.  lse, gathered logits and the gradients dh and
dw must agree within 1e-5: both are float32, and only the order of the
float32 sums differs.  The CUDA kernel is held against the same plain
version on the card by ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.sparse_ce import sparse_ce_lse_gather as jax_lse_gather  # noqa: E402
from repro.kernels.sparse_ce import sparse_ce_lse_gather_ref as jax_lse_gather_ref  # noqa: E402
from repro.kernels.sparse_ce import topk_distill_ce as jax_topk_distill_ce  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.sparse_ce import kernel, ops, ref  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed, t, d, v, k):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(t, d)).astype(np.float32)
    w = (rng.normal(size=(d, v)) / np.sqrt(d)).astype(np.float32)
    idx = rng.integers(0, v, (t, k)).astype(np.int32)
    idx[0, 0] = v - 1                         # the last column, always
    if k > 1:
        idx[:, 1] = idx[:, 0]                 # a duplicate id in every row
    return h, w, idx


# (T, D, V, K, softcap): V=97 and 300 are no multiple of any tile; T up
# to 256 spans two of the reference's 128-row tiles
CASES = [(16, 32, 97, 1, 0.0), (33, 32, 97, 20, 0.0), (256, 32, 300, 20, 0.0),
         (40, 48, 300, 5, 30.0), (128, 32, 97, 20, 30.0)]


@pytest.mark.parametrize("t,d,v,k,cap", CASES)
def test_lse_gather_matches_jax(t, d, v, k, cap):
    h, w, idx = _inputs(t + v + k, t, d, v, k)
    jl, jz = jax_lse_gather(jnp.asarray(h), jnp.asarray(w), jnp.asarray(idx),
                            softcap=cap, interpret=True)
    rl, rz = jax_lse_gather_ref(jnp.asarray(h), jnp.asarray(w),
                                jnp.asarray(idx), softcap=cap)
    pl, pz = ops.sparse_ce_lse_gather(torch.from_numpy(h),
                                      torch.from_numpy(w),
                                      torch.from_numpy(idx), softcap=cap)
    assert pl.shape == (t,) and pz.shape == (t, k)
    assert pl.dtype == pz.dtype == torch.float32
    for a, b in ((pl, jl), (pz, jz), (pl, rl), (pz, rz)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    if k > 1:                                 # duplicates gather one value
        np.testing.assert_array_equal(pz[:, 0].numpy(), pz[:, 1].numpy())


@pytest.mark.parametrize("t,d,v,k,cap", CASES)
def test_lse_gather_grads_match_jax(t, d, v, k, cap):
    """dh, dw through the autograd function (chunked recompute, scatter-
    add at duplicate ids) against jax.grad of the custom_vjp."""
    h, w, idx = _inputs(t * 7 + v, t, d, v, k)
    rng = np.random.default_rng(t)
    gl = rng.normal(size=(t,)).astype(np.float32)
    gz = rng.normal(size=(t, k)).astype(np.float32)

    def jloss(hh, ww):
        lse, z = jax_lse_gather(hh, ww, jnp.asarray(idx), softcap=cap,
                                interpret=True)
        return jnp.sum(lse * gl) + jnp.sum(z * gz)

    jdh, jdw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    ph = torch.from_numpy(h).requires_grad_(True)
    pw = torch.from_numpy(w).requires_grad_(True)
    lse, z = ops.sparse_ce_lse_gather(ph, pw, torch.from_numpy(idx),
                                      softcap=cap)
    (torch.sum(lse * torch.from_numpy(gl))
     + torch.sum(z * torch.from_numpy(gz))).backward()
    np.testing.assert_allclose(ph.grad.numpy(), np.asarray(jdh), **TOL)
    np.testing.assert_allclose(pw.grad.numpy(), np.asarray(jdw), **TOL)


def test_backward_chunks_span_the_vocab():
    """The chunked backward over several narrow chunks (the last one
    ragged) equals autograd through the full-logit plain version."""
    h, w, idx = _inputs(5, 24, 16, 300, 4)
    th, tw, ti = (torch.from_numpy(a) for a in (h, w, idx))
    lse, z = ref.sparse_ce_lse_gather_ref(th, tw, ti, softcap=30.0)
    gl, gz = torch.randn(lse.shape), torch.randn(z.shape)
    dh, dw = ops.lse_gather_bwd(th, tw, ti, lse, gl, gz, softcap=30.0,
                                chunk=64)
    a = th.clone().requires_grad_(True)
    b = tw.clone().requires_grad_(True)
    l2, z2 = ref.sparse_ce_lse_gather_ref(a, b, ti, softcap=30.0)
    rdh, rdw = torch.autograd.grad((l2 * gl).sum() + (z2 * gz).sum(), (a, b))
    np.testing.assert_allclose(dh.numpy(), rdh.numpy(), **TOL)
    np.testing.assert_allclose(dw.numpy(), rdw.numpy(), **TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_topk_distill_ce_matches_jax(masked):
    t, d, v, k = 64, 32, 97, 20
    h, w, idx = _inputs(11, t, d, v, k)
    rng = np.random.default_rng(12)
    vals = rng.normal(size=(t, k)).astype(np.float32)
    mask = (rng.random(t) < 0.7).astype(np.float32) if masked else None

    def jloss(hh, ww):
        return jax_topk_distill_ce(hh, ww, jnp.asarray(vals),
                                   jnp.asarray(idx), interpret=True,
                                   mask=None if mask is None
                                   else jnp.asarray(mask))

    jl, (jdh, jdw) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w))
    ph = torch.from_numpy(h).requires_grad_(True)
    pw = torch.from_numpy(w).requires_grad_(True)
    pl = ops.topk_distill_ce(ph, pw, torch.from_numpy(vals),
                             torch.from_numpy(idx),
                             mask=None if mask is None
                             else torch.from_numpy(mask))
    pl.backward()
    np.testing.assert_allclose(pl.item(), float(jl), **TOL)
    np.testing.assert_allclose(ph.grad.numpy(), np.asarray(jdh), **TOL)
    np.testing.assert_allclose(pw.grad.numpy(), np.asarray(jdw), **TOL)
    if not masked:
        np.testing.assert_allclose(
            float(ref.topk_distill_ce_ref(torch.from_numpy(h),
                                          torch.from_numpy(w),
                                          torch.from_numpy(vals),
                                          torch.from_numpy(idx))),
            float(jl), **TOL)


def test_wrappers_validate_without_loading_a_kernel():
    h = torch.zeros((4, 8))
    w = torch.zeros((8, 10))
    idx = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        ops.sparse_ce_lse_gather(h, w, idx.long())
    with pytest.raises(ValueError, match="float32"):
        ops.sparse_ce_lse_gather(h.double(), w, idx)
    with pytest.raises(ValueError, match="contiguous"):
        ops.sparse_ce_lse_gather(h, torch.zeros((10, 8)).T, idx)
    with pytest.raises(ValueError, match="CUDA"):
        ops.sparse_ce_lse_gather(h, w, idx, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.sparse_ce_tiles(h, w, idx)
    assert "sparse_ce" not in _build._LIBS
