"""Top-k logit wire format (paper §3.2.2).

"we store only the k highest valued logits ... We found storing the
top-20 values for k to be sufficient."  Only the codec that serving
emits is ported: values shifted so the max logit is 0, cast to bf16,
with int32 senone ids.  The reconstruction and the on-disk stores come
with the target-generation slice.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.topk_logits import topk_logits


def topk_compress(logits: torch.Tensor, k: int):
    """logits (..., V) -> (vals (..., k) bf16, idx (..., k) int32).

    Selection runs through ``kernels/topk_logits`` (the CUDA kernel on a
    CUDA tensor, its plain version on a CPU tensor).  Softmax is
    shift-invariant and bf16 precision concentrates near 0, so values
    are stored max-shifted.
    """
    vals, idx = topk_logits(logits, k)
    return shift_to_bf16(vals), idx


def shift_to_bf16(vals: torch.Tensor) -> torch.Tensor:
    """Sorted top-k values -> the wire's max-shifted bf16 values."""
    return (vals - vals[..., :1]).to(torch.bfloat16)
