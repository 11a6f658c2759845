"""The weight bridge: reference (JAX) parameters -> the port's modules.

The reference's param trees are nested dicts of arrays, all applied as
``x @ w``; the port keeps that layout (no transposes) under the same
names with ``.`` for ``/``:

  * the AM: ``l{i}/wx`` (D_in, 4H), ``l{i}/wh`` (H, 4H), ``l{i}/b``
    (4H,) — or ``l{i}/fwd/*`` and ``l{i}/bwd/*`` for the biLSTM — and
    ``out`` (H * dirs, V);
  * the decoder LM: ``embed`` (V, D), ``final_norm/scale``, ``out`` when
    untied, and per segment ``seg{si}/p{i}/{norm1,mixer,norm2,ffn}/*``
    stacked over the segment's ``repeat`` layers on a leading axis (an
    ffn-less block has no ``norm2`` or ``ffn``; a recurrent mixer's
    leaves, sLSTM's 3-D ``rh`` and its ``mlp/*``, cross by name alike);
    with multi-token prediction ``mtp/norm/scale``, ``mtp/proj`` and
    ``mtp/block/*``, a stack of one block;
  * whisper: ``enc_pos``, ``enc_norm/*``, ``embed``, ``dec_pos``,
    ``final_norm/*``, and ``enc_blocks/{norm1,mixer,norm2,ffn}/*`` and
    ``dec_blocks/{norm1,self,norm_x,cross,norm2,ffn}/*`` stacked over
    the layers on a leading axis.
    Each stacked leaf is unstacked into one parameter per layer:
    ``seg{si}/p{i}/mixer/wq[g]`` is ``seg{si}.{g}.p{i}.mixer.wq``,
    ``mtp/block/mixer/w_dq[0]`` is ``mtp.block.0.mixer.w_dq`` and
    ``dec_blocks/cross/wq[l]`` is ``dec_blocks.{l}.cross.wq``.

Inputs are numpy: ``jax.device_get(params)`` as nested dicts, a flat
``{path: array}`` dict, or a checkpoint the reference wrote with
``checkpoint/store.py:save_tree`` (``t::<path>`` npz keys), read by
``load_jax_npz``.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.models.lstm_am import LstmAM
from repro_torch.models.transformer import Transformer
from repro_torch.models.whisper import Whisper
from repro_torch.utils.trees import tree_paths


def _flat(tree_or_flat: Mapping) -> Dict[str, np.ndarray]:
    """{'/'-joined path: array} from a nested tree or an already-flat
    dict (whose values are all leaves)."""
    if all(not isinstance(v, (dict, list, tuple))
           for v in tree_or_flat.values()):
        return dict(tree_or_flat)
    return dict(tree_paths(tree_or_flat))


def params_from_numpy(tree_or_flat: Mapping, cfg, device="cuda"
                      ) -> Dict[str, torch.Tensor]:
    """The port's state dict for ``cfg``'s model from reference
    parameters.

    Every expected leaf must be present with its exact shape, and no
    other leaf may be: a mismatch raises rather than loading a partial
    model.  Values become float32 tensors on ``device`` (npz stores bf16
    as f32 already).
    """
    flat = _flat(tree_or_flat)
    if cfg.family == "lstm_am":
        make = LstmAM
    elif cfg.encoder is not None:
        make = Whisper
    else:
        make = Transformer
    like = make(cfg, device="meta", generator=None)
    # port name -> (reference path, layer index in its stack or None)
    where = {name: _reference_path(name) for name in like.state_dict()}
    depth = {}                              # stacked path -> its layers
    for path, layer in where.values():
        if layer is not None:
            depth[path] = max(depth.get(path, 0), layer + 1)
    want = {}
    for name, t in like.state_dict().items():
        path, layer = where[name]
        shape = tuple(t.shape)
        if layer is not None:
            shape = (depth[path],) + shape
        want[path] = shape
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise KeyError(f"param paths differ from {cfg.name}: missing "
                       f"{missing}, unexpected {extra}")
    arrays = {}
    for path, shape in want.items():
        a = np.asarray(flat[path], dtype=np.float32)
        if a.shape != shape:
            raise ValueError(f"shape mismatch at {path}: got {a.shape}, "
                             f"{cfg.name} needs {shape}")
        arrays[path] = a
    out = {}
    for name, (path, layer) in where.items():
        a = arrays[path] if layer is None else arrays[path][layer]
        out[name] = torch.tensor(a, device=device)
    return out


_STACKS = ("enc_blocks", "dec_blocks")      # whisper's stacked blocks


def _reference_path(name: str):
    """The port's parameter name -> (reference path, stacked-layer index
    or None): ``seg0.3.p0.mixer.wq`` -> (``seg0/p0/mixer/wq``, 3),
    ``dec_blocks.5.self.wq`` -> (``dec_blocks/self/wq``, 5),
    ``mtp.block.0.mixer.w_dq`` -> (``mtp/block/mixer/w_dq``, 0)."""
    parts = name.split(".")
    if (parts[0].startswith("seg") and parts[0][3:].isdigit()) \
            or parts[0] in _STACKS:
        return "/".join([parts[0]] + parts[2:]), int(parts[1])
    if parts[:2] == ["mtp", "block"]:
        return "/".join(parts[:2] + parts[3:]), int(parts[2])
    return "/".join(parts), None


def load_jax_npz(path: str) -> Dict[str, np.ndarray]:
    """{path: array} from a reference checkpoint (``t::<path>`` keys)."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as z:
        return {k[3:]: z[k] for k in z.files if k.startswith("t::")}
