"""Shared building blocks.  Only the initializer the AM needs is ported.

Random draws come from an explicit CPU ``torch.Generator`` and are then
moved to the target device, so one seed gives the same weights on the
host and on the card.
"""
from __future__ import annotations

import math

import torch


def dense_init(fan_in: int, fan_out: int, *, generator: torch.Generator,
               device="cpu") -> torch.Tensor:
    """(fan_in, fan_out) float32 weight ~ N(0, 1 / fan_in), applied as
    ``x @ w`` (the reference's layout, no transpose)."""
    w = torch.randn((fan_in, fan_out), generator=generator,
                    dtype=torch.float32) / math.sqrt(max(fan_in, 1))
    return w.to(device)
