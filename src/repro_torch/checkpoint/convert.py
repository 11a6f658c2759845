"""The weight bridge: reference (JAX) parameters -> the port's modules.

The reference's param tree for the AM is nested dicts of arrays:
``l{i}/wx`` (D_in, 4H), ``l{i}/wh`` (H, 4H), ``l{i}/b`` (4H,) — or
``l{i}/fwd/*`` and ``l{i}/bwd/*`` for the biLSTM — and ``out``
(H * dirs, V), all applied as ``x @ w``.  The port keeps that layout
unchanged (no transposes) under the same names with ``.`` for ``/``.

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
    """The port's state dict for ``cfg``'s AM from reference parameters.

    Every expected leaf must be present with its exact shape, and no
    other leaf may be: a mismatch raises rather than loading a partial
    model.  Values become float32 tensors on ``device`` (npz stores bf16
    as f32 already).
    """
    flat = _flat(tree_or_flat)
    like = LstmAM(cfg, device="meta", generator=None).state_dict()
    want = {k.replace(".", "/"): tuple(v.shape) for k, v in like.items()}
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise KeyError(f"param paths differ from {cfg.name}: missing "
                       f"{missing}, unexpected {extra}")
    out = {}
    for path, shape in want.items():
        a = np.asarray(flat[path], dtype=np.float32)
        if a.shape != shape:
            raise ValueError(f"shape mismatch at {path}: got {a.shape}, "
                             f"{cfg.name} needs {shape}")
        out[path.replace("/", ".")] = torch.tensor(a, device=device)
    return out


def load_jax_npz(path: str) -> Dict[str, np.ndarray]:
    """{path: array} from a reference checkpoint (``t::<path>`` keys)."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as z:
        return {k[3:]: z[k] for k in z.files if k.startswith("t::")}
