"""TrainState: the single carried state of every trainer in the port.

One object holds everything a training loop mutates -- params, optimizer
state, the update counter, the random-stream root, and whatever the
distributed strategy carries between updates (GTC's error-feedback
residual).  ``params`` is a state dict in the reference's leaf order
(``utils.trees.leaf_order``), the canonical model every consumer reads.

``step`` is a host int (the reference carries a device scalar and the
Trainer mirrors it on the host; here the host copy is the only one).
``rng`` is a seed or a ``torch.Generator``: the AM's losses draw
nothing, and a loss that declares ``rng`` receives
``fold_rng(state.rng, state.step)``, a generator unique per update.
``restack_workers`` comes with the elastic slice.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Union

import torch


def fold_rng(rng: Union[int, torch.Generator], step: int) -> torch.Generator:
    """A CPU generator for update ``step`` from the stream root: unique
    per (root, step) and exact under replay, as the reference's
    ``fold_in(key, step)``."""
    root = rng.initial_seed() if isinstance(rng, torch.Generator) else rng
    return torch.Generator().manual_seed(
        hash((int(root), int(step))) & (2 ** 63 - 1))


@dataclass
class TrainState:
    params: Any                 # state dict (canonical model params)
    opt_state: Any              # {"mu": state dict} / Adam's moments
    strategy_state: Any         # GTC: {"residual": state dict}
    step: int                   # optimizer updates taken
    rng: Any                    # seed (int) or torch.Generator

    def replace(self, **kw) -> "TrainState":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        rng = self.rng.initial_seed() if isinstance(
            self.rng, torch.Generator) else self.rng
        return {"params": self.params, "opt": self.opt_state,
                "strategy": self.strategy_state, "step": self.step,
                "rng": rng}
