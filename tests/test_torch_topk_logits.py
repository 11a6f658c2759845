"""Port parity: ``repro_torch.kernels.topk_logits`` vs the JAX reference.

On the CPU the port's wrapper runs its plain version; the reference runs
its Pallas kernel in interpret mode.  Values and ids must match exactly,
ties included (ties go to the smallest id).  The CUDA kernel itself is
held against the same plain versions on the card by ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.topk_logits import topk_logits as jax_topk_logits  # noqa: E402
from repro.kernels.topk_logits.kernel import NEG as JAX_NEG  # noqa: E402
from repro.kernels.topk_logits.kernel import \
    topk_logits_tiles as jax_topk_logits_tiles  # noqa: E402
from repro_torch.kernels import _build, _dispatch  # noqa: E402
from repro_torch.kernels.topk_logits import kernel, ops, ref  # noqa: E402


def _logits(seed, shape, kind):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    if kind == "ties":          # 5 levels: most of the top-k are ties
        x = (np.clip(np.round(x * 1.5), -2, 2) * 0.75).astype(np.float32)
    return x


# (rows, V, k, kind): V=25/97 one tile, V=300 a padded tile, V=2500 two
# 2048-wide tiles (the second mostly NEG padding) and a real merge, V=2053
# a second tile of 5 real columns (stage 1 repeats its first NEG column)
CASES = [(6, 25, 5, "continuous"), (6, 25, 5, "ties"),
         (9, 97, 20, "continuous"), (9, 97, 20, "ties"),
         (9, 97, 1, "ties"), (4, 300, 7, "ties"),
         (5, 2500, 20, "continuous"), (5, 2500, 20, "ties"),
         (3, 2500, 1, "ties"), (4, 2053, 20, "continuous"),
         (4, 2053, 20, "ties")]


@pytest.mark.parametrize("rows,v,k,kind", CASES)
def test_topk_logits_matches_jax_exactly(rows, v, k, kind):
    x = _logits(rows * v + k, (rows, v), kind)
    jv, ji = jax_topk_logits(jnp.asarray(x), k, interpret=True)
    pv, pi = ops.topk_logits(torch.from_numpy(x), k)
    assert pv.dtype == torch.float32 and pi.dtype == torch.int32
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))


def test_topk_logits_leading_dims():
    """(..., V) in, (..., k) out: the serving emitter's (B, T, V) shape."""
    x = _logits(1, (2, 7, 97), "ties")
    jv, ji = jax_topk_logits(jnp.asarray(x), 20, interpret=True)
    pv, pi = ops.topk_logits(torch.from_numpy(x), 20)
    assert tuple(pv.shape) == (2, 7, 20)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("rows,v,k,kind", CASES)
def test_tiles_ref_matches_jax_tile_kernel(rows, v, k, kind):
    """Stage 1: the plain candidates == the Pallas tile kernel's, on the
    reference's own padded input (rows to r_tile, vocab to whole tiles
    of NEG) — the port pads the vocab itself."""
    x = _logits(rows * v + k + 1, (rows, v), kind)
    vt = ref.tile_width(v)
    kk = min(k, vt)
    n_tiles = -(-v // vt)
    xp = np.full((-(-rows // 8) * 8, n_tiles * vt), JAX_NEG, np.float32)
    xp[:rows, :v] = x
    jv, ji = jax_topk_logits_tiles(jnp.asarray(xp), k=kk, r_tile=8,
                                   v_tile=vt, interpret=True)
    pv, pi = ref.topk_logits_tiles_ref(torch.from_numpy(x), kk, vt)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji)[:rows])
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv)[:rows])
    # already-padded input gives the same candidates
    pv2, pi2 = ref.topk_logits_tiles_ref(torch.from_numpy(xp), kk, vt)
    np.testing.assert_array_equal(pi2.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pv2.numpy(), np.asarray(jv))


def test_tiles_ref_repeats_first_neg_like_reference():
    """A tile with fewer than k values above NEG: the reference keeps
    re-extracting its first NEG column (the winner is overwritten with
    NEG and stays eligible); the stage-1 contract keeps that quirk."""
    x = np.full((8, 128), JAX_NEG, np.float32)
    x[:, 3] = 1.0
    x[:, 70] = 2.0
    jv, ji = jax_topk_logits_tiles(jnp.asarray(x), k=5, r_tile=8,
                                   v_tile=128, interpret=True)
    pv, pi = ref.topk_logits_tiles_ref(torch.from_numpy(x), 5, 128)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    assert list(pi[0].numpy()) == [70, 3, 0, 0, 0]


@pytest.mark.parametrize("v,v_tile,want", [(25, 2048, 128), (97, 2048, 128),
                                           (300, 2048, 512),
                                           (3183, 2048, 2048),
                                           (262144, 2048, 2048)])
def test_tile_width_matches_reference_choice(v, v_tile, want):
    assert ref.tile_width(v, v_tile) == want


def test_merge_of_tile_candidates_is_the_global_topk():
    """The two-stage decomposition the CUDA path runs (candidates, then a
    stable merge over candidate positions with ids read through the
    candidate ids) equals the one-shot sort, ties included."""
    x = torch.from_numpy(_logits(3, (6, 5000), "ties"))
    cv, ci = ref.topk_logits_tiles_ref(x, 20, 2048)
    mv, pos = ref.topk_logits_ref(cv, 20)
    mi = torch.gather(ci, 1, pos.long())
    sv, si = ref.topk_logits_ref(x, 20)
    assert torch.equal(mv, sv) and torch.equal(mi, si)


@pytest.mark.parametrize("v,k,fused", [
    (97, 20, True), (3183, 20, True), (2053, 20, True),
    (2048, 20, True),                   # exactly one tile
    (8 * 2048, 20, True),               # exactly 8 tiles: one block
    (8 * 2048 + 1, 20, False),          # a ninth tile: two launches
    (9 * 2048, 20, False),
    (32768, 20, False), (151_936, 32, False),
    (4 * 2048, 512, True),              # 4 x 512 candidates fill the merge
    (4 * 2048, 513, False),
    (3183, 1024, True), (3183, 1025, False),
])
def test_fused_merge_choice(v, k, fused):
    """One launch where a row's tiles fit one block (<= 8 warps) and
    their min(k, v_tile) candidates each the block's merge (<= 2048)."""
    vt = ref.tile_width(v)
    assert kernel.fused_merge(v, k, vt) is fused
    nt = -(-v // vt)
    assert fused == (nt <= kernel.MAX_WARPS
                     and nt * min(k, vt) <= kernel.MAX_ENTRIES)


@pytest.mark.parametrize("c,k,fits", [
    (320, 20, True), (2400, 32, True), (8 * 2048, 256, True),
    (8 * 2048 + 1, 1, False), (3 * 2048, 683, False), (3 * 2048, 682, True),
])
def test_merge_fits(c, k, fits):
    assert kernel.merge_fits(c, k) is fits


def _largest_k(v):
    """The largest k the card path takes for a row of ``v`` logits."""
    vt = ref.tile_width(v)
    nt = -(-v // vt)
    return max(k for k in range(1, v + 1)
               if kernel.fused_merge(v, k, vt)
               or kernel.merge_fits(nt * min(k, vt), k))


@pytest.mark.parametrize("v,k_max", [(3183, 1024), (151_936, 218)])
def test_merge_width_limit(v, k_max):
    """The limit the kernel module's docstring states."""
    assert _largest_k(v) == k_max


def test_signed_zero_ties_follow_the_reference_op():
    """[-0, +0, -0, +0, -1] at k = 4: ids in id order as the reference's
    op gives them (not ``lax.top_k``'s +0-first [1, 3, 0, 2]); values
    equal to the op's as numbers, each the selected element's own zero
    (the op returns four +0: the documented difference)."""
    import jax
    x = np.asarray([[-0.0, 0.0, -0.0, 0.0, -1.0]], np.float32)
    jv, ji = jax_topk_logits(jnp.asarray(x), 4, interpret=True)
    pv, pi = ops.topk_logits(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(np.asarray(ji), [[0, 1, 2, 3]])
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(np.signbit(pv.numpy()),
                                  [[True, False, True, False]])
    np.testing.assert_array_equal(np.signbit(np.asarray(jv)),
                                  [[False] * 4])
    _, li = jax.lax.top_k(jnp.asarray(x), 4)
    np.testing.assert_array_equal(np.asarray(li), [[1, 3, 0, 2]])
    cv, ci = ref.topk_logits_tiles_ref(torch.from_numpy(x), 4, 128)
    np.testing.assert_array_equal(ci[0].numpy(), [0, 1, 2, 3])
    np.testing.assert_array_equal(np.signbit(cv[0].numpy()),
                                  [True, False, True, False])


def _rank_merge(runs, k):
    """The kernel's merge, in numpy: runs sorted by (value desc, position
    asc); an entry's rank is its index plus, for every other run, the
    entries there that come before it (a binary search on the values).
    Returns the entries (run, index) of rank 0 .. k-1 in rank order."""
    out = {}
    for t, run in enumerate(runs):
        for i, v in enumerate(run):
            rank = i
            for u, other in enumerate(runs):
                if u != t:
                    # sorted descending: count the values > v (>= v in an
                    # earlier run) with a search on the negated run
                    side = "right" if u < t else "left"
                    rank += int(np.searchsorted(-other, -v, side=side))
            if rank < k:
                assert rank not in out
                out[rank] = (t, i)
    return [out[r] for r in range(k)]


@pytest.mark.parametrize("v", [97, 2053, 3183, 4096, 16 * 1024])
@pytest.mark.parametrize("kind", ["continuous", "ties"])
@pytest.mark.parametrize("k", [1, 20])
def test_rank_merge_of_tile_runs_is_the_merge(v, kind, k):
    """The rank merge of the stage-1 runs (each tile's candidates, sorted
    by value with ties in position order, NEG repeats included) gives the
    stable top-k over candidate positions, which is the row's top-k."""
    x = torch.from_numpy(_logits(v + k, (3, v), kind))
    vt = ref.tile_width(v)
    kk = min(k, vt)
    cv, ci = ref.topk_logits_tiles_ref(x, kk, vt)
    sv, si = ref.topk_logits_ref(x, k)
    for row in range(3):
        runs = cv[row].numpy().reshape(-1, kk)
        picked = _rank_merge(list(runs), k)
        vals = np.asarray([runs[t, i] for t, i in picked])
        ids = np.asarray([ci[row].numpy().reshape(-1, kk)[t, i]
                          for t, i in picked])
        np.testing.assert_array_equal(vals, sv[row].numpy())
        np.testing.assert_array_equal(ids, si[row].numpy())


# ---------------------------------------------------------------- dispatch

def test_dispatch_cpu_runs_plain_version():
    x = torch.zeros(3, 4)
    assert _dispatch.auto_use_kernel(x) is False
    assert _dispatch.auto_use_kernel(x, False) is False
    with pytest.raises(ValueError, match="CUDA"):
        _dispatch.auto_use_kernel(x, True)
    with pytest.raises(ValueError, match="CUDA"):
        ops.topk_logits(torch.zeros(2, 97), 5, use_kernel=True)


@pytest.mark.parametrize("call", ["tiles", "merge"])
def test_kernel_wrappers_refuse_cpu_tensors(call):
    """The kernel wrappers launch on CUDA tensors or raise: never a
    silent plain-version fallback."""
    x = torch.zeros(4, 97)
    with pytest.raises(ValueError, match="CUDA"):
        if call == "tiles":
            kernel.topk_logits_tiles(x, 5, 128)
        else:
            kernel.topk_logits_merge(x, torch.zeros(4, 97,
                                                    dtype=torch.int32), 5)
    assert kernel.LAUNCHES == 0


def test_resolve_device_rule():
    assert _dispatch.resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        for dev in (None, "cuda"):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                _dispatch.resolve_device(dev)


# ------------------------------------------------------------------- build

def test_build_sources_and_content_addressed_paths(tmp_path, monkeypatch):
    assert "topk_logits" in _build.sources()
    assert "tc_common" not in _build.sources()      # a header, no library
    p = _build.lib_path("topk_logits")
    assert p.parent == _build.BUILD_DIR and p.suffix == ".so"
    assert p == _build.lib_path("topk_logits")      # stable per source
    with pytest.raises(KeyError):
        _build.load("no_such_kernel")
    # both tensor-core kernels hash the shared header they include
    for name in ("swa_attention", "sparse_ce"):
        assert (_build.CSRC / "tc_common.cuh").read_bytes() in \
            _build._source_bytes(_build.sources()[name])
    # an edited header renames (so rebuilds) exactly the libraries that
    # include it
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text('#include "common.cuh"\nint a;\n')
    (csrc / "common.cuh").write_text("#pragma once\n")
    (csrc / "b.cu").write_text("#include <cmath>\nint b;\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert sorted(_build.sources()) == ["a", "b"]
    pa, pb = _build.lib_path("a"), _build.lib_path("b")
    (csrc / "common.cuh").write_text("#pragma once\n// edited\n")
    assert _build.lib_path("a") != pa and _build.lib_path("b") == pb


def test_build_failure_raises_with_compiler_output(tmp_path, monkeypatch):
    """A failed nvcc raises with its output and leaves no library."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: refused by the fake nvcc'\n"
                    "exit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="refused by the fake nvcc"):
        _build.build_all()
    assert not list((tmp_path / "kernels").iterdir())
