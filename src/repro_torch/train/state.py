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
``restack_workers`` comes with the elastic slice.
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
