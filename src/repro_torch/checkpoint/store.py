"""Checkpointing: the reference's flat-key npz store over the port's
state dicts.

The twin of the reference's ``checkpoint/store.py``, writing its file:
``<root>/step_<n>.npz`` with one ``t::<reference path>`` array per leaf
(bf16 stored as float32) and ``step_<n>.npz.meta.json`` beside it.  A
state dict's names translate to the reference's paths through
``checkpoint/convert.py:_reference_path`` (``l0.fwd.wx`` is
``l0/fwd/wx``; a transformer segment's per-layer parameters are stacked
back on a leading axis), so each package loads the other's checkpoints.
"""
from __future__ import annotations

import json
import os
import re
from collections import defaultdict
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.checkpoint.convert import _reference_path, load_jax_npz


def _flatten(state: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """{reference path: array} from a state dict."""
    out: Dict[str, np.ndarray] = {}
    stacks = defaultdict(dict)                # path -> {layer: array}
    for name, t in state.items():
        a = torch.as_tensor(t).detach().cpu()
        if a.dtype == torch.bfloat16:         # npz has no bf16: store f32,
            a = a.float()                     # load_tree casts back
        path, layer = _reference_path(name)
        if layer is None:
            out[path] = a.numpy()
        else:
            stacks[path][layer] = a.numpy()
    for path, layers in stacks.items():
        if sorted(layers) != list(range(len(layers))):
            raise ValueError(f"{path}: layers {sorted(layers)} are not "
                             f"0..{len(layers) - 1}")
        out[path] = np.stack([layers[i] for i in range(len(layers))])
    return out


def save_tree(path: str, state: Mapping[str, torch.Tensor], *,
              meta: Optional[dict] = None):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = _flatten(state)
    # the reference's leaf order: sorted keys at every level
    np.savez(path, **{f"t::{k}": flat[k]
                      for k in sorted(flat, key=lambda p: p.split("/"))})
    if meta is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f)


def load_tree(path: str, like: Mapping[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
    """Restore into the names, shapes and dtypes of the state dict
    ``like``, on its tensors' devices (a ``meta`` template, which holds
    shapes only, loads onto the host)."""
    stored = load_jax_npz(path)
    out = {}
    for name, template in like.items():
        ref_path, layer = _reference_path(name)
        if ref_path not in stored:
            raise KeyError(f"checkpoint missing leaf {ref_path!r}")
        arr = stored[ref_path]
        if layer is not None:
            arr = arr[layer]
        if tuple(arr.shape) != tuple(template.shape):
            raise ValueError(f"shape mismatch at {ref_path}: ckpt "
                             f"{arr.shape} vs template "
                             f"{tuple(template.shape)}")
        dev = "cpu" if template.device.type == "meta" else template.device
        out[name] = torch.from_numpy(np.ascontiguousarray(arr)).to(
            device=dev, dtype=template.dtype)
    return out


class CheckpointStore:
    """<root>/step_<n>.npz rolling store with retention."""

    def __init__(self, root: str, *, keep: int = 3):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:08d}.npz")

    def save(self, step: int, state, *, meta: Optional[dict] = None):
        save_tree(self.path(step), state, meta={"step": step,
                                                **(meta or {})})
        self._gc()

    def steps(self):
        out = []
        for f in os.listdir(self.root):
            m = re.match(r"step_(\d+)\.npz$", f)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def load(self, like, step: Optional[int] = None):
        step = self.latest() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        return load_tree(self.path(step), like), step

    def leaf_shapes(self, step: Optional[int] = None) -> Dict[str, tuple]:
        """{reference path: stored shape} without materializing the
        arrays (the probe a resume uses to learn how a checkpoint was
        laid out before asking ``load_tree`` for it)."""
        step = self.latest() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        with np.load(self.path(step)) as z:
            return {k[3:]: tuple(z[k].shape) for k in z.files
                    if k.startswith("t::")}

    def load_meta(self, step: int) -> Optional[dict]:
        meta = self.path(step) + ".meta.json"
        if not os.path.exists(meta):
            return None
        with open(meta) as f:
            return json.load(f)

    def clear(self):
        """Drop every checkpoint (a completed stage retires its resume
        state so a fresh invocation trains anew)."""
        for s in self.steps():
            self._remove(s)

    def _remove(self, step: int):
        os.remove(self.path(step))
        meta = self.path(step) + ".meta.json"
        if os.path.exists(meta):
            os.remove(meta)

    def _gc(self):
        for s in self.steps()[: -self.keep]:
            self._remove(s)
