"""Hopper kernel for candidate merge + Gumbel-max sampling: build, binding
and launch.

The CUDA source is ``kernels/csrc/topk_sample.cu`` (its header says what
it replaces and what bounds it): stage 2 of the fused sampler, after the
``topk_logits`` stage-1 kernel.  It is built by ``kernels/_build.py`` at
first use and bound with ``ctypes``: pointers, the shapes and the current
stream go in, outputs are allocated here with ``torch.empty``, and a
launch error raises.

``LAUNCHES`` counts launches of the stage-2 kernel (stage 1 counts in
``topk_logits.kernel.LAUNCHES``); it is incremented only here, right
after a launch that succeeded.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

LAUNCHES = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("topk_sample")
    if lib.topk_sample.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.topk_sample.argtypes = [p, p, ctypes.c_longlong, i, i, p, p, p,
                                    p, p, p, p, i, p]
        lib.topk_sample.restype = i
        lib.topk_sample_error_string.argtypes = [i]
        lib.topk_sample_error_string.restype = ctypes.c_char_p
        for fn in (lib.topk_sample_max_candidates, lib.topk_sample_max_k):
            fn.argtypes = []
            fn.restype = i
    return lib


def _check(t: torch.Tensor, name: str, shape, dtype, device):
    if t.device != device or t.dtype != dtype or \
            tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {tuple(shape)} "
                         f"{dtype} tensor on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def topk_sample_tiles(cand_v: torch.Tensor, cand_i: torch.Tensor,
                      temp: Optional[torch.Tensor],
                      top_k: Optional[torch.Tensor],
                      top_p: Optional[torch.Tensor],
                      gumbel: Optional[torch.Tensor], *, k_cap: int,
                      greedy: bool = False):
    """cand_v (R, C) f32 / cand_i (R, C) i32 per-tile candidates;
    temp, top_p (R,) f32, top_k (R,) i32, gumbel (R, k_cap) f32 (all
    unused, and may be None, when ``greedy``).

    Returns (vals (R, k_cap) f32 desc, idx (R, k_cap) i32, token (R,) i32).
    """
    global LAUNCHES
    if cand_v.device.type != "cuda" or cand_v.dim() != 2:
        raise ValueError(f"cand_v: expected a 2-D CUDA tensor, got "
                         f"{tuple(cand_v.shape)} on {cand_v.device}")
    r, c = cand_v.shape
    dev = cand_v.device
    _check(cand_v, "cand_v", (r, c), torch.float32, dev)
    _check(cand_i, "cand_i", (r, c), torch.int32, dev)
    if not greedy:
        _check(temp, "temperature", (r,), torch.float32, dev)
        _check(top_k, "top_k", (r,), torch.int32, dev)
        _check(top_p, "top_p", (r,), torch.float32, dev)
        _check(gumbel, "gumbel", (r, k_cap), torch.float32, dev)
    lib = _lib()
    if not 1 <= k_cap <= min(c, lib.topk_sample_max_k()) or \
            c > lib.topk_sample_max_candidates():
        raise ValueError(f"topk_sample takes 1 <= k_cap <= min(C, "
                         f"{lib.topk_sample_max_k()}) and C <= "
                         f"{lib.topk_sample_max_candidates()}; got "
                         f"k_cap={k_cap}, C={c}")
    vals = torch.empty((r, k_cap), dtype=torch.float32, device=dev)
    idx = torch.empty((r, k_cap), dtype=torch.int32, device=dev)
    tok = torch.empty((r,), dtype=torch.int32, device=dev)

    def ptr(t):
        return None if greedy else t.data_ptr()

    with torch.cuda.device(dev):
        err = lib.topk_sample(
            cand_v.data_ptr(), cand_i.data_ptr(), r, c, k_cap, ptr(temp),
            ptr(top_k), ptr(top_p), ptr(gumbel), vals.data_ptr(),
            idx.data_ptr(), tok.data_ptr(), int(greedy),
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError("topk_sample launch failed: "
                           + lib.topk_sample_error_string(err).decode())
    LAUNCHES += 1
    return vals, idx, tok
