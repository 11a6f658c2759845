"""Public entry point for causal sliding-window attention over a whole
sequence (prefill).

``swa_attention`` is the op ``models/attention.attention_apply`` calls on
a CUDA tensor, for both of the reference's branches: the windowed one
(``window = spec.window``) and the causal one (``window = S``).  On a
CUDA tensor it launches the Hopper kernel; on a CPU tensor it is
``swa_attention_ref`` with the kv heads repeated G-fold, as the
reference's wrapper repeats them (``kernels/_dispatch.py``).

Unlike the reference's TPU path, nothing is padded or repeated on the
card: the kernel reads any S and any head dim up to its limit in place
with ``scale = float32(1/sqrt(hd))``, and each query head reads its kv
head by index.  The kernel has no backward: on a CUDA tensor under
autograd the op raises rather than run anything else.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels._dispatch import auto_use_kernel
from repro_torch.kernels.swa_attention.kernel import swa_attention_tiles
from repro_torch.kernels.swa_attention.ref import swa_attention_ref

NO_BACKWARD = ("swa_attention has no backward yet: training the token LM "
               "through the full-sequence forward is ROADMAP Queue 1, step "
               "10d; run prefill under torch.inference_mode()")


def check_no_autograd(*tensors: torch.Tensor):
    """Raise ``NotImplementedError`` if autograd would track any of
    ``tensors``: the kernel computes a forward only."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(NO_BACKWARD)


def swa_attention(q, k, v, window: int, *, softcap: float = 0.0,
                  use_kernel: Optional[bool] = None):
    """q (B,Hq,S,hd); k/v (B,Hkv,S,hd), Hq % Hkv == 0.  Causal + window:
    key j is visible to query i iff ``i - window < j <= i`` (window >= 1;
    a window of at least S is plain causal attention).

    Returns (B,Hq,S,hd) f32.  On a CUDA tensor, views (such as the
    transposed heads ``_project_qkv`` returns) are copied to contiguous
    tensors first; inputs are f32 or bf16.
    """
    if int(window) < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if not auto_use_kernel(q, use_kernel):
        g = q.shape[1] // k.shape[1]
        if g > 1:
            k = k.repeat_interleave(g, dim=1)
            v = v.repeat_interleave(g, dim=1)
        return swa_attention_ref(q, k, v, window, softcap=softcap)
    check_no_autograd(q, k, v)
    hd = q.shape[-1]
    return swa_attention_tiles(
        q.contiguous(), k.contiguous(), v.contiguous(), window=int(window),
        scale=float(np.float32(1.0 / np.sqrt(hd))), softcap=float(softcap))
