"""TrainState: the single carried state of every trainer in the port.

One object holds everything a training loop mutates -- params, optimizer
state, the update counter, the random-stream root, and whatever the
distributed strategy carries between updates (BMUF's block momentum and
W-stacked worker replicas, GTC's error-feedback residual).  ``params``
is a state dict in the reference's leaf order (``utils.trees.leaf_order``)
and is always the canonical model: for BMUF it is theta_g, never a
worker replica.

``step`` is a host int (the reference carries a device scalar and the
Trainer mirrors it on the host; here the host copy is the only one).
``rng`` is a seed or a ``torch.Generator``: the AM's losses draw
nothing, and a loss that declares ``rng`` receives
``fold_rng(state.rng, state.step)``, a generator unique per update (BMUF
folds the lane and the local step in as well).

The state round-trips through ``checkpoint/store.py`` as the reference's
plain dict (``to_dict`` / ``from_dict``): ``step`` as an int32 scalar,
``rng`` as the uint32 key data of the reference's ``jax.random.key(seed)``
(``[0, seed]``), so either package resumes the other's checkpoints.

``restack_workers`` re-partitions W-stacked state onto a new worker
count: the elastic-membership primitive every strategy's ``resize``
builds on.  ``cut_lanes`` keeps a ``runtime.cluster.WorkerMesh``'s rows
of a W-stacked tree (a rank holds its own lanes only) and
``gather_lanes`` puts the ranks' rows back together in lane order over
the host group, so a gathered tree is bitwise the single-process one.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Union

import numpy as np
import torch


def _root(rng: Union[int, torch.Generator]) -> int:
    return rng.initial_seed() if isinstance(rng, torch.Generator) \
        else int(rng)


def fold_seed(rng: Union[int, torch.Generator], *path: int) -> int:
    """A seed unique per (root, *path) and exact under replay, as the
    reference's chain of ``fold_in(key, i)``."""
    return hash((_root(rng),) + tuple(int(i) for i in path)) & (2 ** 63 - 1)


def fold_rng(rng: Union[int, torch.Generator], *path: int
             ) -> torch.Generator:
    """A CPU generator for ``fold_seed(rng, *path)``: ``fold_rng(root,
    step)`` is update ``step``'s stream."""
    return torch.Generator().manual_seed(fold_seed(rng, *path))


def key_data(seed: int) -> np.ndarray:
    """The uint32 key data of the reference's ``jax.random.key(seed)``,
    ``[0, seed]``: the reference (64-bit types off) keeps 32 bits of a
    seed, so a seed outside [0, 2**32) has no key it would write."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 32:
        raise ValueError(f"seed {seed} is outside [0, 2**32): the "
                         "reference's key holds 32 bits of it")
    return np.array([0, seed], np.uint32)


def seed_of(data) -> int:
    """The seed whose key data ``key_data`` gives ``data``."""
    hi, lo = (int(x) for x in np.asarray(data, np.uint32).reshape(2))
    return (hi << 32) | lo


def _map(fn, tree):
    """``fn`` over the leaves of nested dicts."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _first_leaf(tree):
    """The first leaf in the reference's order (sorted keys), or None."""
    while isinstance(tree, dict):
        if not tree:
            return None
        tree = tree[min(tree, key=lambda k: str(k).split("."))]
    return tree


def restack_workers(tree, w_new: int, *, fold: bool = False):
    """Re-partition a W-stacked tree onto a new leading worker dim.

    Shrink (``w_new < W``): the first ``w_new`` rows survive; with
    ``fold=True`` the dropped rows are added onto the survivors
    round-robin (row ``j`` onto row ``j % w_new``, in row order) so the
    leading-dim *sum* is kept -- the GTC residuals' conservation
    invariant (sends + residuals == grads) holds across a membership
    change.  Grow (``w_new > W``): new rows are zeros under ``fold`` (a
    joiner starts with no residual debt) and copies of row 0 otherwise
    (a BMUF joiner warm-starts from a survivor's replica and optimizer
    state).  Leaves are tensors (new tensors, the input untouched) or
    numpy arrays.
    """
    if w_new < 1:
        raise ValueError(f"w_new must be >= 1, got {w_new}")

    def leaf(x):
        x = torch.as_tensor(x)
        w = x.shape[0]
        if w_new == w:
            return x
        if w_new < w:
            head = x[:w_new].clone()
            if fold:
                for j in range(w_new, w):
                    head[j % w_new] += x[j].to(head.dtype)
            return head
        rest = (w_new - w,) + tuple(x.shape[1:])
        pad = (x.new_zeros(rest) if fold
               else x[0].unsqueeze(0).expand(rest))
        return torch.cat([x, pad], dim=0)

    return _map(leaf, tree)


def cut_lanes(tree, mesh, *, dim: int = 0):
    """This rank's rows (``mesh.lanes``) of a W-stacked tree, along
    ``dim`` (1 for BMUF's (tau, W, ...) batches).  A rank past the
    mesh's axis keeps zero rows; the one-rank mesh keeps the tree."""
    lanes = list(mesh.lanes)

    def leaf(x):
        x = torch.as_tensor(x)
        if lanes == list(range(x.shape[dim])):
            return x
        return x.index_select(dim, torch.tensor(lanes, dtype=torch.long,
                                                device=x.device))

    return _map(leaf, tree)


def gather_lanes(tree, mesh):
    """The full W-stacked tree from every rank's rows of it, over the
    host group: each leaf the ranks' rows concatenated in rank order (=
    lane order), on the device of this rank's leaf (``mesh.device`` where
    this rank holds none, e.g. the metrics of a rank without lanes).  The
    structure is rank 0's, which always holds lanes.  The tree itself
    without a group."""
    from repro_torch.runtime.cluster import all_gather_object
    if not mesh.distributed:
        return tree
    parts = all_gather_object(_map(lambda x: x.detach().cpu(), tree))

    def walk(ps, local):
        if isinstance(ps[0], dict):
            return {k: walk([p[k] for p in ps if k in p],
                            local.get(k) if isinstance(local, dict)
                            else None) for k in ps[0]}
        dev = local.device if torch.is_tensor(local) else (mesh.device
                                                           or "cpu")
        return torch.cat(ps, 0).to(dev)

    return walk(parts, tree)


def worker_dim(tree) -> int:
    """Leading dim of the first leaf: the W a stacked tree is laid out
    for (0 for an empty tree or a scalar leaf)."""
    x = _first_leaf(tree)
    shape = tuple(np.shape(x)) if x is not None else ()
    return int(shape[0]) if shape else 0


@dataclass
class TrainState:
    params: Any                 # state dict (theta_g for BMUF)
    opt_state: Any              # {"mu": state dict} / Adam's moments,
                                # W-stacked for BMUF
    strategy_state: Any         # GTC: {"residual": ...}; BMUF: {"delta",
                                # "workers"}
    step: int                   # optimizer updates taken
    rng: Any                    # seed (int) or torch.Generator

    def replace(self, **kw) -> "TrainState":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        return {"params": self.params, "opt": self.opt_state,
                "strategy": self.strategy_state, "step": int(self.step),
                "rng": key_data(_root(self.rng))}

    @classmethod
    def from_dict(cls, d: dict) -> "TrainState":
        return cls(params=d["params"], opt_state=d["opt"],
                   strategy_state=d["strategy"], step=int(d["step"]),
                   rng=seed_of(d["rng"]))
