"""Port parity: the LSTM acoustic model, its configs and the weight bridge.

The same weights (JAX init, carried over by ``params_from_numpy``) and the
same numpy inputs go through the JAX ``LstmAM`` and the port's.  Logits
must agree within rtol 1e-5 / atol 1e-5 on the valid frames of ragged
padded batches: both run float32, and only the order of float32 sums
differs (the port takes the input projection of all frames in one
product).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.checkpoint import save_tree  # noqa: E402
from repro.configs.base import Segment as JaxSegment  # noqa: E402
from repro.configs.lstm_am_7khr import CONFIG as JAX_CONFIG  # noqa: E402
from repro.configs.lstm_am_7khr import TEACHER as JAX_TEACHER  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import recurrent as jax_recurrent  # noqa: E402
from repro.utils.trees import tree_paths as jax_tree_paths  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import load_jax_npz, params_from_numpy  # noqa: E402
from repro_torch.configs.base import Segment  # noqa: E402
from repro_torch.configs.lstm_am_7khr import CONFIG, TEACHER  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers, recurrent  # noqa: E402
from repro_torch.utils.trees import tree_paths  # noqa: E402

F = 6
TOL = dict(rtol=1e-5, atol=1e-5)


def _tiny(base, seg_cls, v):
    return base.replace(
        lstm_hidden=16, feat_dim=F, n_senones=v, vocab_size=v,
        segments=(seg_cls((base.segments[0].pattern[0],), repeat=2),))


def _pair(kind, v):
    """(jax cfg, port cfg, jax model, jax params, port model)."""
    jbase, pbase = ((JAX_CONFIG, CONFIG) if kind == "student"
                    else (JAX_TEACHER, TEACHER))
    jcfg, pcfg = _tiny(jbase, JaxSegment, v), _tiny(pbase, Segment, v)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.key(0 if kind == "student" else 1))
    pm = build_model(pcfg, device="cpu",
                     params=params_from_numpy(jax.device_get(jp), pcfg,
                                              device="cpu"))
    return jcfg, pcfg, jm, jp, pm


_PAIRS = {}


def pair(kind, v=25):
    if (kind, v) not in _PAIRS:
        _PAIRS[kind, v] = _pair(kind, v)
    return _PAIRS[kind, v]


def _feats(seed, b, t):
    return np.random.default_rng(seed).normal(size=(b, t, F)).astype(
        np.float32)


# ------------------------------------------------------------------ model

@pytest.mark.parametrize("kind", ["student", "teacher"])
@pytest.mark.parametrize("v", [25, 97])
def test_logits_match_jax_on_ragged_batch(kind, v):
    _, _, jm, jp, pm = pair(kind, v)
    lens = np.array([11, 40, 23, 1], np.int32)
    x = _feats(2, 4, 40)
    jh, _ = jm.apply(jp, jnp.asarray(x), lens=jnp.asarray(lens))
    jl = np.asarray(jm.unembed(jp, jh))
    with torch.no_grad():
        ph, _ = pm.apply(torch.from_numpy(x), lens=torch.from_numpy(lens))
        pl = pm.unembed(ph)
    assert pl.dtype == torch.float32 and tuple(pl.shape) == (4, 40, v)
    for b, n in enumerate(lens):
        np.testing.assert_allclose(pl[b, :n].numpy(), jl[b, :n], **TOL)


@pytest.mark.parametrize("kind", ["student", "teacher"])
def test_logits_match_jax_unpadded(kind):
    _, _, jm, jp, pm = pair(kind)
    x = _feats(3, 2, 17)
    jl, _ = jm.logits(jp, jnp.asarray(x))
    with torch.no_grad():
        pl, _ = pm.logits(torch.from_numpy(x))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)


def test_student_state_matches_jax():
    """The carried (h, c) of a lens-masked batch: h in the input dtype,
    c in float32, frozen at each row's length."""
    _, _, jm, jp, pm = pair("student")
    lens = np.array([9, 20, 3], np.int32)
    x = _feats(4, 3, 20)
    _, jaux = jm.apply(jp, jnp.asarray(x), lens=jnp.asarray(lens))
    with torch.no_grad():
        _, paux = pm.apply(torch.from_numpy(x),
                           lens=torch.from_numpy(lens))
    for (jh, jc), (ph, pc) in zip(jaux["state"], paux["state"]):
        assert ph.dtype == torch.float32 and pc.dtype == torch.float32
        np.testing.assert_allclose(ph.numpy(), np.asarray(jh), **TOL)
        np.testing.assert_allclose(pc.numpy(), np.asarray(jc), **TOL)


def test_lstm_cell_matches_jax():
    rng = np.random.default_rng(5)
    p = {"wx": rng.normal(size=(F, 64)).astype(np.float32),
         "wh": rng.normal(size=(16, 64)).astype(np.float32) * 0.3,
         "b": rng.normal(size=(64,)).astype(np.float32)}
    x, h = (rng.normal(size=(3, F)).astype(np.float32),
            rng.normal(size=(3, 16)).astype(np.float32))
    c = rng.normal(size=(3, 16)).astype(np.float32)
    jh, jc = jax_recurrent.lstm_cell({k: jnp.asarray(a) for k, a in p.items()},
                                     jnp.asarray(x), jnp.asarray(h),
                                     jnp.asarray(c))
    ph, pc = recurrent.lstm_cell({k: torch.from_numpy(a) for k, a in p.items()},
                                 torch.from_numpy(x), torch.from_numpy(h),
                                 torch.from_numpy(c))
    np.testing.assert_allclose(ph.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), **TOL)
    # the cell is the step lstm_apply runs: chained, it gives the same run
    tp = {k: torch.from_numpy(a) for k, a in p.items()}
    xs = torch.from_numpy(rng.normal(size=(3, 5, F)).astype(np.float32))
    ys, (ah, ac) = recurrent.lstm_apply(tp, xs, state=(torch.from_numpy(h),
                                                       torch.from_numpy(c)))
    ch, cc = torch.from_numpy(h), torch.from_numpy(c)
    for t in range(5):
        ch, cc = recurrent.lstm_cell(tp, xs[:, t], ch, cc)
        np.testing.assert_allclose(ch.numpy(), ys[:, t].numpy(), **TOL)
    np.testing.assert_allclose(ch.numpy(), ah.numpy(), **TOL)
    np.testing.assert_allclose(cc.numpy(), ac.numpy(), **TOL)


@pytest.mark.parametrize("trail", [(), (3,), (2, 2)])
def test_masked_reverse_matches_jax_bitwise(trail):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(4, 9) + trail).astype(np.float32)
    lens = np.array([9, 0, 4, 1], np.int32)
    j = jax_recurrent.masked_reverse(jnp.asarray(x), jnp.asarray(lens))
    p = recurrent.masked_reverse(torch.from_numpy(x), torch.from_numpy(lens))
    np.testing.assert_array_equal(p.numpy(), np.asarray(j))
    # an involution on the valid region
    pp = recurrent.masked_reverse(p, torch.from_numpy(lens))
    for b, n in enumerate(lens):
        np.testing.assert_array_equal(pp[b, :n].numpy(), x[b, :n])


# -------------------------------------------------------------- streaming

def test_chunked_stream_step_equals_full_apply():
    """Chunked stream_step calls (with a ragged, lens-masked last chunk)
    == one full apply(): outputs and the final carried state."""
    _, _, _, _, pm = pair("student")
    x = torch.from_numpy(_feats(7, 2, 30))
    with torch.no_grad():
        full_h, aux = pm.apply(x)
        st = pm.init_stream_state(2)
        parts = []
        for lo in (0, 10, 20):
            h, st = pm.stream_step(st, x[:, lo:lo + 10])
            parts.append(h)
        torch.testing.assert_close(torch.cat(parts, 1), full_h, **TOL)
        for (h1, c1), (h2, c2) in zip(st, aux["state"]):
            torch.testing.assert_close(h1, h2, **TOL)
            torch.testing.assert_close(c1, c2, **TOL)
        # row 1 stops at frame 25 of 30: its state == a 25-frame run
        st = pm.init_stream_state(2)
        _, st = pm.stream_step(st, x[:, :20])
        _, st = pm.stream_step(st, x[:, 20:30],
                               lens=torch.tensor([10, 5], dtype=torch.int32))
        _, ref = pm.apply(x[1:2, :25])
        torch.testing.assert_close(st[0][0][1], ref["state"][0][0][0], **TOL)


def test_reset_rows_and_pull_put_bitwise():
    _, _, _, _, pm = pair("student")
    with torch.no_grad():
        _, st = pm.stream_step(pm.init_stream_state(3),
                               torch.from_numpy(_feats(8, 3, 5)))
        row = pm.pull_stream_row(st, 1)
        assert all(a.device.type == "cpu" for hc in row for a in hc)
        reset = pm.reset_stream_rows(st, torch.tensor([False, True, False]))
        for (h0, c0), (h1, c1) in zip(st, reset):
            assert torch.equal(h1[0], h0[0]) and torch.equal(c1[2], c0[2])
            assert not h1[1].any() and not c1[1].any()
        back = pm.put_stream_row(reset, 1, row)
        for (h0, c0), (h1, c1) in zip(st, back):
            assert torch.equal(h0, h1) and torch.equal(c0, c1)   # bitwise


def test_bidirectional_has_no_stream_form():
    _, _, _, _, pm = pair("teacher")
    assert pm.init_state(2) is None
    with pytest.raises(ValueError, match="bidirectional"):
        pm.init_stream_state(2)


# ----------------------------------------------------------- weight bridge

@pytest.mark.parametrize("kind", ["student", "teacher"])
def test_load_jax_npz_roundtrip(kind, tmp_path):
    """A checkpoint the reference writes (``t::<path>`` keys) loads into
    the port bitwise, and the param names follow the reference's paths."""
    _, pcfg, _, jp, pm = pair(kind)
    path = str(tmp_path / "ckpt.npz")
    save_tree(path, jp)
    flat = load_jax_npz(path)
    assert sorted(flat) == sorted(p for p, _ in jax_tree_paths(jp))
    sd = params_from_numpy(flat, pcfg, device="cpu")
    for name, t in pm.state_dict().items():
        assert torch.equal(sd[name], t)
        np.testing.assert_array_equal(
            t.numpy(), np.asarray(flat[name.replace(".", "/")]))


def test_params_from_numpy_refuses_mismatch():
    jcfg, pcfg, _, jp, _ = pair("student")
    flat = dict(jax_tree_paths(jax.device_get(jp)))
    missing = {k: v for k, v in flat.items() if k != "l1/wh"}
    with pytest.raises(KeyError, match="l1/wh"):
        params_from_numpy(missing, pcfg, device="cpu")
    with pytest.raises(KeyError, match="extra"):
        params_from_numpy({**flat, "extra": np.zeros(1)}, pcfg, device="cpu")
    bad = {**flat, "out": np.zeros((16, 24), np.float32)}
    with pytest.raises(ValueError, match="out"):
        params_from_numpy(bad, pcfg, device="cpu")
    # the teacher's layout does not load into the student
    _, _, _, tp, _ = pair("teacher")
    with pytest.raises(KeyError):
        params_from_numpy(jax.device_get(tp), pcfg, device="cpu")


def test_tree_paths_match_reference():
    tree = {"b": {"z": np.zeros(2), "a": [np.ones(1), np.ones(3)]},
            "a": np.zeros(4), "l10": {"fwd": {"wx": np.zeros(1)}}}
    got = [p for p, _ in tree_paths(tree)]
    assert got == [p for p, _ in jax_tree_paths(tree)]
    assert "b/a/1" in got


# ---------------------------------------------------------------- configs

def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("arch", ["lstm-am-7khr", "lstm-am-teacher",
                                  "gemma3-27b", "gemma3-27b+swa",
                                  "deepseek-67b", "deepseek-67b+swa",
                                  "chameleon-34b", "chameleon-34b+swa",
                                  "qwen3-moe-30b-a3b",
                                  "qwen3-moe-30b-a3b+swa"])
@pytest.mark.parametrize("cut", [False, True])
def test_configs_match_reference(arch, cut):
    p, j = configs.get_arch(arch), jax_configs.get_arch(arch)
    if cut:
        p, j = configs.reduced(p), jax_configs.reduced(j)
    jf = _fields(j)
    for name, val in _fields(p).items():
        if name == "segments":
            assert [(s.repeat, [dataclasses.astuple(x) for x in s.pattern])
                    for s in val] == \
                [(s.repeat, [dataclasses.astuple(x) for x in s.pattern])
                 for s in jf[name]]
        elif name in ("mla", "encoder"):
            assert (val is None) == (jf[name] is None)
        else:
            assert val == jf[name], name
    assert p.n_layers == j.n_layers and p.mixers() == j.mixers()


def test_unported_arch_raises():
    with pytest.raises(KeyError, match="not ported yet"):
        configs.get_arch("deepseek-v3-671b")
    with pytest.raises(KeyError, match="not ported yet"):
        configs.get_arch("xlstm-350m+swa")
    with pytest.raises(KeyError, match="not ported yet"):
        configs.get_arch("recurrentgemma-2b+swa")
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_arch("no-such-arch")
    assert set(configs.NOT_PORTED) | set(configs.ARCHS) == \
        set(jax_configs.ARCHS)


# ------------------------------------------------------------------- init

def test_dense_init_is_seeded_and_scaled():
    a = layers.dense_init(400, 300, generator=torch.Generator().manual_seed(3))
    b = layers.dense_init(400, 300, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and a.dtype == torch.float32
    assert abs(float(a.std()) - 1 / 20) < 2e-3


def test_build_model_needs_weights_and_device():
    pcfg = pair("student")[1]
    with pytest.raises(ValueError, match="generator"):
        build_model(pcfg, device="cpu")
    m = build_model(pcfg, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    m2 = build_model(pcfg, device="cpu", params=m.state_dict())
    for (n1, t1), (n2, t2) in zip(m.state_dict().items(),
                                  m2.state_dict().items()):
        assert n1 == n2 and torch.equal(t1, t2)
    assert sorted(m.state_dict()) == ["l0.b", "l0.wh", "l0.wx", "l1.b",
                                      "l1.wh", "l1.wx", "out"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build_model(pcfg, generator=torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="not ported"):
        build_model(pcfg.replace(family="dense"), device="cpu",
                    generator=torch.Generator())
