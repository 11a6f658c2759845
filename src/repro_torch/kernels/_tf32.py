"""The TF32 split of the tensor-core kernels' 3xTF32 products, on the
host: the twin of ``csrc/tc_common.cuh``'s ``tf32_rna``, ``split`` and
``split_int``, which ``swa_attention.cu`` and ``sparse_ce.cu`` share.  The host twins of
those kernels (``swa_attention/ref.py:swa_attention_tiled_ref``,
``sparse_ce/ref.py:sparse_ce_tiled_ref``) split their operands with it;
no model path calls it.
"""
from __future__ import annotations

import torch


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on the float bits: round to the nearest TF32
    value (10 stored mantissa bits), ties away from zero, the low 13 bits
    zero.  ±0, subnormals and ±inf go through the same bit rounding (a
    subnormal may round up to the smallest normal; a value within half a
    TF32 unit of the largest float rounds to inf); NaN stays NaN."""
    x = x.float().contiguous()
    u = x.view(torch.int32)
    # sign and magnitude: adding half a TF32 unit to the magnitude bits
    # rounds ties away from zero; the carry may cross into the exponent
    r = ((u & 0x7FFFFFFF) + 0x1000) & 0x7FFFE000
    r = r | (u & -0x80000000)
    return torch.where(torch.isnan(x), x, r.view(torch.float32))


def tf32_split(x: torch.Tensor):
    """(big, small) with big = tf32(x) and small = tf32(x - big): x to
    about 2^-22 of |x|, the kernel's 3xTF32 operands."""
    big = tf32_rna(x)
    return big, tf32_rna(x.float() - big)
