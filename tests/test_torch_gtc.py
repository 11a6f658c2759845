"""Port parity: GTC threshold compression and its wire.

On the CPU the port's ``gtc_compress`` wrapper runs its plain version;
the reference runs its Pallas kernel in interpret mode and its jnp ref.
Send and residual must match bitwise (the reference pins kernel == ref
bitwise), including |acc| == tau, zeros, -0, NaN and lengths that are
not multiples of the reference's 8,192-value tile.  The CUDA kernel is
held against the same plain version on the card by ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.distributed import gtc as jax_gtc  # noqa: E402
from repro.kernels.gtc_compress import gtc_compress as jax_gtc_compress  # noqa: E402
from repro.kernels.gtc_compress import gtc_compress_ref as jax_gtc_ref  # noqa: E402
from repro_torch.distributed import gtc  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.gtc_compress import kernel, ops, ref  # noqa: E402
from repro_torch.utils.trees import leaf_order  # noqa: E402

TAU = 2e-4


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def _inputs(seed, shape, tau=TAU):
    """grad/residual around tau, with the edge values written in."""
    rng = np.random.default_rng(seed)
    g = (rng.normal(size=shape) * tau).astype(np.float32)
    r = (rng.normal(size=shape) * tau).astype(np.float32)
    fg, fr = g.reshape(-1), r.reshape(-1)
    edges = [(tau, 0.0), (-tau, 0.0), (tau / 2, tau / 2), (0.0, 0.0),
             (-0.0, -0.0), (np.nan, 0.0), (1.0, np.nan), (np.inf, 0.0),
             (-np.inf, 0.0)]
    for i, (a, b) in enumerate(edges[:fg.size]):
        fg[i], fr[i] = a, b
    return g, r


SHAPES = [(7,), (8192,), (8193,), (3, 1000), (12, 34, 5), (64, 97)]


@pytest.mark.parametrize("shape", SHAPES)
def test_gtc_compress_bitwise_vs_jax_kernel_and_ref(shape):
    g, r = _inputs(len(shape) * 31 + shape[-1], shape)
    js, jr = jax_gtc_compress(jnp.asarray(g), jnp.asarray(r), TAU,
                              interpret=True)
    rs, rr = jax_gtc_ref(jnp.asarray(g), jnp.asarray(r), TAU)
    ps, pr = ops.gtc_compress(torch.from_numpy(g), torch.from_numpy(r), TAU)
    assert ps.dtype == torch.float32 and tuple(ps.shape) == shape
    for port, (a, b) in ((ps, (js, rs)), (pr, (jr, rr))):
        np.testing.assert_array_equal(_bits(port.numpy()), _bits(a))
        np.testing.assert_array_equal(_bits(port.numpy()), _bits(b))


def test_gtc_compress_edges():
    """send is exactly +-tau or 0; 0 at |acc| == tau, zeros and NaN;
    the residual keeps acc - send (NaN stays NaN)."""
    g, r = _inputs(0, (9,))
    s, nr = ref.gtc_compress_ref(torch.from_numpy(g), torch.from_numpy(r),
                                 TAU)
    s, nr = s.numpy(), nr.numpy()
    tau32 = np.float32(TAU)
    np.testing.assert_array_equal(s[:7], np.zeros(7, np.float32))
    assert np.isnan(nr[5]) and np.isnan(nr[6])
    assert s[7] == tau32 and s[8] == -tau32
    assert nr[2] == tau32 and np.signbit(nr[4])


def test_gtc_compress_validates():
    g = torch.zeros(4)
    with pytest.raises(ValueError, match="tau"):
        ops.gtc_compress(g, g, -1e-3)
    with pytest.raises(ValueError, match="shape"):
        ops.gtc_compress(g, torch.zeros(5), TAU)
    with pytest.raises(ValueError, match="CUDA"):
        ops.gtc_compress(g, g, TAU, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.gtc_compress_flat(g, g, TAU)
    assert "gtc_compress" not in _build._LIBS


def _tree(seed, shapes):
    rng = np.random.default_rng(seed)
    return {n: (rng.normal(size=s) * TAU * 3).astype(np.float32)
            for n, s in shapes.items()}


SHAPES_TREE = {"l0.wx": (6, 8), "l0.wh": (2, 8), "l0.b": (8,),
               "l1.wx": (2, 8), "l1.wh": (2, 8), "l1.b": (8,),
               "out": (2, 5)}


def _nested(flat):
    out = {}
    for n, a in flat.items():
        node = out
        *path, leaf = n.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(a)
    return out


def _flat_jax(tree):
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    return {".".join(k.key for k in path): np.asarray(v)
            for path, v in leaves}


def test_leaf_order_is_the_reference_flatten_order():
    tree = _nested(_tree(0, SHAPES_TREE))
    order = [".".join(k.key for k in path)
             for path, _ in jax.tree_util.tree_leaves_with_path(tree)]
    assert leaf_order(SHAPES_TREE) == order


def test_compress_tree_wire_reduce_momentum_bitwise_vs_jax():
    """Fed the same gradients, compress_tree -> wire_reduce -> momentum
    matches the reference bitwise (the arithmetic is elementwise)."""
    from repro.optim import momentum_init as jmi, momentum_update as jmu
    from repro_torch.optim import momentum_init, momentum_update
    grads, res, params = (_tree(s, SHAPES_TREE) for s in (1, 2, 3))
    cfg_j = jax_gtc.GTCConfig(tau=TAU, n_workers=1)
    cfg_p = gtc.GTCConfig(tau=TAU, n_workers=1)
    js, jr = jax_gtc.compress_tree(_nested(grads), _nested(res), TAU)
    japplied = jax_gtc.wire_reduce(js, cfg_j)
    jp, jo = jmu(_nested(params), japplied, jmi(_nested(params)), lr=5e-2)
    t = lambda d: {n: torch.from_numpy(a) for n, a in d.items()}  # noqa: E731
    ps, pr = gtc.compress_tree(t(grads), t(res), TAU)
    applied = gtc.wire_reduce(ps, cfg_p)
    pp, po = momentum_update(t(params), applied, momentum_init(t(params)),
                             lr=5e-2)
    for jtree, ptree in ((js, ps), (jr, pr), (japplied, applied), (jp, pp),
                         (jo["mu"], po["mu"])):
        jflat = _flat_jax(jtree)
        assert list(ptree) == leaf_order(jflat)
        for n in jflat:
            np.testing.assert_array_equal(_bits(ptree[n].numpy()),
                                          _bits(jflat[n]))
    assert float(gtc.density(applied, TAU)) == pytest.approx(
        float(jax_gtc.density(japplied, TAU)), rel=1e-6)


def test_wire_reduce_is_identity_on_ternary_sends():
    send = torch.tensor([TAU, -TAU, 0.0, TAU, 0.0], dtype=torch.float32)
    cfg = gtc.GTCConfig(tau=TAU, n_workers=1)
    out = gtc.wire_reduce({"x": send}, cfg)["x"]
    np.testing.assert_array_equal(_bits(out.numpy()), _bits(send.numpy()))
    packed = gtc.wire_pack(send, cfg)
    assert packed.dtype == torch.int8
    np.testing.assert_array_equal(packed.numpy(), [1, -1, 0, 1, 0])


@pytest.mark.parametrize("n_workers,int32", [(4, False), (200, True)])
def test_wire_pack_unpack_matches_jax(n_workers, int32):
    rng = np.random.default_rng(n_workers)
    sends = [(rng.integers(-1, 2, 50) * np.float32(TAU)).astype(np.float32)
             for _ in range(3)]
    cfg_j = jax_gtc.GTCConfig(tau=TAU, n_workers=n_workers,
                              int32_accum=int32)
    cfg_p = gtc.GTCConfig(tau=TAU, n_workers=n_workers, int32_accum=int32)
    jacc = sum(jax_gtc.wire_pack(jnp.asarray(s), cfg_j) for s in sends)
    pacc = sum(gtc.wire_pack(torch.from_numpy(s), cfg_p) for s in sends)
    assert pacc.dtype == (torch.int32 if int32 else torch.int8)
    np.testing.assert_array_equal(pacc.numpy(), np.asarray(jacc))
    np.testing.assert_array_equal(
        _bits(gtc.wire_unpack(pacc, cfg_p).numpy()),
        _bits(jax_gtc.wire_unpack(jacc, cfg_j)))


def test_pack_int8_raises_past_127_workers():
    s = torch.zeros(3)
    gtc.pack_int8(s, TAU, n_workers=127)
    with pytest.raises(ValueError, match="overflows int8"):
        gtc.pack_int8(s, TAU, n_workers=128)
    with pytest.raises(ValueError, match="overflows int8"):
        gtc.wire_pack(s, gtc.GTCConfig(tau=TAU, n_workers=128))
    assert gtc.pack_int8(s, TAU, n_workers=128,
                         int32_accum=True).dtype == torch.int8
    np.testing.assert_array_equal(
        gtc.unpack_int8(torch.tensor([3, -2], dtype=torch.int32), TAU,
                        n_workers_summed=4).numpy(),
        np.asarray(jax_gtc.unpack_int8(jnp.asarray([3, -2], jnp.int32),
                                       TAU, n_workers_summed=4)))


def test_gtc_init_shapes_and_order():
    params = {n: torch.ones(s) for n, s in SHAPES_TREE.items()}
    flat = gtc.gtc_init(params)["residual"]
    assert list(flat) == leaf_order(SHAPES_TREE)
    assert all(flat[n].shape == params[n].shape and not flat[n].any()
               for n in flat)
    stacked = gtc.gtc_init(params, gtc.GTCConfig(n_workers=3))["residual"]
    assert stacked["out"].shape == (3, 2, 5)
    assert stacked["out"].dtype == torch.float32
