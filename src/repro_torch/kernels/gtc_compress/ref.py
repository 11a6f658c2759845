"""Plain PyTorch version of the GTC threshold-compression kernel.

The CPU paths and the tests use it; ``chip_smoke.py`` holds the CUDA
kernel against it, bitwise, on the card.
"""
from __future__ import annotations

import torch


def gtc_compress_ref(grad: torch.Tensor, residual: torch.Tensor, tau: float):
    """(send, new_residual): error-feedback threshold sparsification.

    acc  = residual + grad
    send = tau * sign(acc) * [|acc| > tau]
    new_residual = acc - send
    """
    acc = residual.float() + grad.float()
    send = torch.where(acc.abs() > tau, torch.sign(acc) * tau,
                       torch.zeros((), dtype=torch.float32,
                                   device=acc.device))
    return send, acc - send
