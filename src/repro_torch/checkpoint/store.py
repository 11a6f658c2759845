"""Checkpointing: the reference's flat-key npz store over the port's
state dicts and TrainState dicts.

The twin of the reference's ``checkpoint/store.py``, writing its file:
``<root>/step_<n>.npz`` with one ``t::<reference path>`` array per leaf
(bf16 stored as float32) and ``step_<n>.npz.meta.json`` beside it.  A
tree is a nested dict whose leaves are tensors, numpy arrays or host
ints: a state dict, or ``TrainState.to_dict()`` (``{"params", "opt",
"strategy", "step", "rng"}``, whose values nest state dicts).  Each
leaf's key translates to the reference's path through
``checkpoint/convert.py:_reference_path`` (``l0.fwd.wx`` is
``l0/fwd/wx``; a transformer segment's per-layer parameters are stacked
back on a leading axis) under its dict keys: ``opt/mu/l0/wx``,
``strategy/workers/l0/wx`` (with BMUF's leading W).  A host int is the
reference's int32 scalar (``step``).  So each package loads the other's
checkpoints.
"""
from __future__ import annotations

import json
import os
import re
from collections import defaultdict
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.checkpoint.convert import _reference_path, load_jax_npz
from repro_torch.models.lstm_am import LstmAM


def _host_array(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        a = x.detach().cpu()
        if a.dtype == torch.bfloat16:         # npz has no bf16: store f32,
            a = a.float()                     # load_tree casts back
        return a.numpy()
    if isinstance(x, (int, np.integer)):
        return np.asarray(x, np.int32)        # the reference's int32 step
    return np.asarray(x)


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """{reference path: array} from a nested dict of leaves."""
    out: Dict[str, np.ndarray] = {}
    stacks = defaultdict(dict)                # path -> {layer: array}
    for key, x in tree.items():
        if isinstance(x, Mapping):
            out.update(_flatten(x, f"{prefix}{key}/"))
            continue
        path, layer = _reference_path(key)
        if layer is None:
            out[prefix + path] = _host_array(x)
        else:
            stacks[prefix + path][layer] = _host_array(x)
    for path, layers in stacks.items():
        if sorted(layers) != list(range(len(layers))):
            raise ValueError(f"{path}: layers {sorted(layers)} are not "
                             f"0..{len(layers) - 1}")
        out[path] = np.stack([layers[i] for i in range(len(layers))])
    return out


def save_tree(path: str, tree: Mapping, *, meta: Optional[dict] = None):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = _flatten(tree)
    # the reference's leaf order: sorted keys at every level
    np.savez(path, **{f"t::{k}": flat[k]
                      for k in sorted(flat, key=lambda p: p.split("/"))})
    if meta is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f)


def _restore(stored: Dict[str, np.ndarray], like: Mapping, prefix: str):
    out = {}
    for name, template in like.items():
        if isinstance(template, Mapping):
            out[name] = _restore(stored, template, f"{prefix}{name}/")
            continue
        ref_path, layer = _reference_path(name)
        ref_path = prefix + ref_path
        if ref_path not in stored:
            raise KeyError(f"checkpoint missing leaf {ref_path!r}")
        arr = stored[ref_path]
        if layer is not None:
            arr = arr[layer]
        shape = tuple(np.shape(template))
        if tuple(arr.shape) != shape:
            raise ValueError(f"shape mismatch at {ref_path}: ckpt "
                             f"{arr.shape} vs template {shape}")
        if isinstance(template, torch.Tensor):
            dev = "cpu" if template.device.type == "meta" \
                else template.device
            out[name] = torch.from_numpy(np.ascontiguousarray(arr)).to(
                device=dev, dtype=template.dtype)
        elif isinstance(template, (int, np.integer)):
            out[name] = int(arr)
        else:
            out[name] = np.asarray(arr, np.asarray(template).dtype)
    return out


def load_tree(path: str, like: Mapping) -> Dict[str, Any]:
    """Restore into the structure, names, shapes and dtypes of ``like``
    (a nested dict of tensors, arrays and ints), tensors on their
    template's device (a ``meta`` template, which holds shapes only,
    loads onto the host)."""
    return _restore(load_jax_npz(path), like, "")


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


def load_params(cfg, ckpt_dir: str, device, step: Optional[int] = None):
    """The ``LstmAM`` state dict of ``cfg`` that ``ckpt_dir`` (a
    ``CheckpointStore`` root) holds at ``step`` (default: the latest), on
    ``device``; None when no step is asked for and there is no checkpoint
    (the template a meta-device model: shapes only)."""
    store = CheckpointStore(ckpt_dir)
    if step is None and store.latest() is None:
        return None
    like = LstmAM(cfg, device="meta", generator=None).state_dict()
    params, _ = store.load(like, step)
    return {n: p.to(device) for n, p in params.items()}
