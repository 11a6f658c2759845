"""Port parity: the checkpoint store (``checkpoint/store.py``) against the
JAX reference.

Each package loads the other's checkpoint bitwise: a reference
``save_tree`` / ``CheckpointStore`` checkpoint into the port's state dict
(the AM, a biLSTM teacher, and a 3-layer dense LM whose segment leaves
the port keeps one parameter per layer), and the port's into the
reference's ``load_tree``.  Retention, metadata and the leaf-shape probe
behave as the reference's.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import store as jckpt  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.configs.base import Segment as JaxSegment  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.utils.trees import tree_paths as jax_tree_paths  # noqa: E402
from repro_torch.checkpoint import (CheckpointStore, load_tree,  # noqa: E402
                                    params_from_numpy, save_tree)
from repro_torch.checkpoint.convert import _reference_path  # noqa: E402
from repro_torch.configs import get_arch, reduced  # noqa: E402
from repro_torch.configs.base import Segment  # noqa: E402
from repro_torch.models import LstmAM, Transformer  # noqa: E402


def _configs(arch):
    jcfg, pcfg = jax_reduced(jax_get_arch(arch)), reduced(get_arch(arch))
    if arch == "qwen2.5-3b":                    # three stacked layers
        jcfg = jcfg.replace(segments=(JaxSegment(
            jcfg.segments[0].pattern, repeat=3),))
        pcfg = pcfg.replace(segments=(Segment(
            pcfg.segments[0].pattern, repeat=3),))
    return jcfg, pcfg


def _template(pcfg):
    cls = LstmAM if pcfg.family == "lstm_am" else Transformer
    return cls(pcfg, device="meta", generator=None).state_dict()


def _same(port_state, jax_tree):
    """Every port tensor equals its reference leaf bitwise."""
    flat = {p: np.asarray(a) for p, a in jax_tree_paths(jax_tree)}
    assert port_state
    for name, t in port_state.items():
        path, layer = _reference_path(name)
        ref = flat[path] if layer is None else flat[path][layer]
        got = t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
        np.testing.assert_array_equal(got, np.asarray(ref, np.float32),
                                      err_msg=name)


ARCHS = ["lstm-am-7khr", "lstm-am-teacher", "qwen2.5-3b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_checkpoint_loads_into_the_port(arch, tmp_path):
    jcfg, pcfg = _configs(arch)
    jp = jax_build_model(jcfg).init(jax.random.key(3))
    jckpt.CheckpointStore(str(tmp_path)).save(7, jp, meta={"stage": "x"})
    store = CheckpointStore(str(tmp_path))
    got, step = store.load(_template(pcfg))
    assert step == 7 and store.load_meta(7) == {"step": 7, "stage": "x"}
    assert all(t.device.type == "cpu" and t.dtype == torch.float32
               for t in got.values())
    _same(got, jp)
    # into a template on the host: the same names, the template's dtype
    like = {n: torch.zeros(t.shape, dtype=torch.bfloat16)
            for n, t in got.items()}
    as_bf16 = load_tree(store.path(7), like)
    assert all(t.dtype == torch.bfloat16 for t in as_bf16.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_port_checkpoint_loads_into_the_reference(arch, tmp_path):
    jcfg, pcfg = _configs(arch)
    jp = jax.device_get(jax_build_model(jcfg).init(jax.random.key(4)))
    state = params_from_numpy(jp, pcfg, device="cpu")
    CheckpointStore(str(tmp_path)).save(3, state)
    like = jax.tree_util.tree_map(jnp.zeros_like, jp)
    back, step = jckpt.CheckpointStore(str(tmp_path)).load(like)
    assert step == 3
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a),
                                                   np.asarray(b)), back, jp)
    # the same leaves in the same order as the reference's own file
    jckpt.save_tree(str(tmp_path / "ref.npz"), jp)
    with np.load(str(tmp_path / "ref.npz")) as a, \
            np.load(CheckpointStore(str(tmp_path)).path(3)) as b:
        assert a.files == b.files
    assert CheckpointStore(str(tmp_path)).leaf_shapes() == \
        jckpt.CheckpointStore(str(tmp_path)).leaf_shapes()


def test_bf16_leaves_stored_as_f32(tmp_path):
    """bf16 tensors are stored as float32 (npz has no bf16) and come back
    in the template's dtype, in both packages."""
    _, pcfg = _configs("lstm-am-7khr")
    state = {n: (torch.arange(t.numel(), dtype=torch.float32)
                 .reshape(t.shape) / 7).to(torch.bfloat16)
             for n, t in _template(pcfg).items()}
    path = str(tmp_path / "c.npz")
    save_tree(path, state, meta={"a": 1})
    with np.load(path) as z:
        assert {z[k].dtype for k in z.files} == {np.dtype(np.float32)}
    back = load_tree(path, state)
    for n in state:
        assert torch.equal(back[n], state[n])
    jlike = jax.tree_util.tree_map(
        lambda a: jnp.zeros(a.shape, jnp.bfloat16),
        jax_build_model(_configs("lstm-am-7khr")[0]).init(jax.random.key(0)))
    jback = jckpt.load_tree(path, jlike)
    for p, a in jax_tree_paths(jback):
        assert a.dtype == jnp.bfloat16
        np.testing.assert_array_equal(
            np.asarray(a.astype(jnp.float32)),
            state[p.replace("/", ".")].float().numpy())


def test_retention_and_clear_match_the_reference(tmp_path):
    """keep=2 over five saves: the same steps, files and metadata survive
    in both packages; clear() drops every checkpoint."""
    _, pcfg = _configs("lstm-am-7khr")
    state = {n: torch.zeros(t.shape) for n, t in _template(pcfg).items()}
    jtree = {"w": jnp.zeros((2, 3))}
    stores = {"port": CheckpointStore(str(tmp_path / "p"), keep=2),
              "jax": jckpt.CheckpointStore(str(tmp_path / "j"), keep=2)}
    for step in (5, 1, 9, 3, 12):
        stores["port"].save(step, state, meta={"s": step})
        stores["jax"].save(step, jtree, meta={"s": step})
    for name, st in stores.items():
        assert st.steps() == [9, 12] and st.latest() == 12, name
        assert sorted(os.listdir(st.root)) == [
            "step_00000009.npz", "step_00000009.npz.meta.json",
            "step_00000012.npz", "step_00000012.npz.meta.json"]
        assert st.load_meta(9) == {"step": 9, "s": 9}
        assert st.load_meta(1) is None
    stores["port"].clear()
    assert stores["port"].steps() == [] and stores["port"].latest() is None
    assert os.listdir(stores["port"].root) == []
    with pytest.raises(FileNotFoundError):
        stores["port"].load(state)
    with pytest.raises(FileNotFoundError):
        stores["port"].leaf_shapes()


def test_load_refuses_missing_and_misshapen_leaves(tmp_path):
    _, pcfg = _configs("lstm-am-7khr")
    like = _template(pcfg)
    state = {n: torch.zeros(t.shape) for n, t in like.items()}
    path = str(tmp_path / "c.npz")
    save_tree(path, {n: t for n, t in state.items() if n != "out"})
    with pytest.raises(KeyError, match="out"):
        load_tree(path, like)
    save_tree(path, {**state, "out": torch.zeros(3, 3)})
    with pytest.raises(ValueError, match="shape mismatch at out"):
        load_tree(path, like)
