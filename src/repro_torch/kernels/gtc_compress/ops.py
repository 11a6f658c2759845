"""Public wrapper: the tensor-shaped GTC compression."""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels._dispatch import auto_use_kernel
from repro_torch.kernels.gtc_compress.kernel import gtc_compress_flat
from repro_torch.kernels.gtc_compress.ref import gtc_compress_ref


def gtc_compress(grad: torch.Tensor, residual: torch.Tensor, tau: float, *,
                 use_kernel: Optional[bool] = None):
    """grad/residual: same shape, any dims; tau: a float >= 0.
    Returns (send, new_residual) shaped like grad, float32.

    On a CUDA tensor the Hopper kernel runs over the flat view (no pad to
    tiles); on a CPU tensor it is ``gtc_compress_ref``.  Both are
    bitwise the reference's arithmetic.
    """
    tau = float(tau)
    if not (tau >= 0 and math.isfinite(tau)):
        raise ValueError(f"tau must be a finite float >= 0, got {tau}")
    if grad.shape != residual.shape:
        raise ValueError(f"grad {tuple(grad.shape)} and residual "
                         f"{tuple(residual.shape)} differ in shape")
    if not auto_use_kernel(grad, use_kernel):
        return gtc_compress_ref(grad, residual, tau)
    g = grad.float().contiguous()
    r = residual.float().contiguous()
    return gtc_compress_flat(g, r, tau)
