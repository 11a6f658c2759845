"""Hopper kernel for candidate merge + Gumbel-max sampling: build, binding
and launch.

The CUDA source is ``kernels/csrc/topk_sample.cu`` (its header says what
it replaces and what bounds it): stage 2 of the fused sampler, after the
``topk_logits`` stage-1 kernel -- a warp per row merging the sorted runs
that stage 1 writes.  It is built by ``kernels/_build.py`` at
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
# The kernel's limits (kMaxK, kMaxCandidates in csrc/topk_sample.cu):
# k_cap <= 32 and C <= 8,192 candidates a row, V <= 524,288 at k_cap = 32
# with 2,048-wide tiles.
MAX_K = 32
MAX_CANDIDATES = 8192


def _lib() -> ctypes.CDLL:
    lib = _build.load("topk_sample")
    if lib.topk_sample.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.topk_sample.argtypes = [p, p, ctypes.c_longlong, i, i, p, p, p,
                                    p, p, p, p, i, p]
        lib.topk_sample.restype = i
        lib.topk_sample_error_string.argtypes = [i]
        lib.topk_sample_error_string.restype = ctypes.c_char_p
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

    Precondition: the candidates are C / k_cap runs of k_cap, each sorted
    by (value desc, position asc) -- what ``topk_logits_tiles`` writes at
    k = k_cap for logits above its NEG mask (-3.4e38), so for every row
    of finite logits, its NEG repeats included (a NEG repeated at a later
    position sorts after the earlier one).  The kernel merges the runs'
    heads; it does not search, so unsorted runs give a wrong top-k
    without an error.  A tile whose first pick lies below NEG (-inf, say)
    breaks it: stage 1 re-marks each winner NEG, which sorts above -inf.
    No path of the port feeds such logits.  Raises ValueError when C is
    not a multiple of k_cap, and outside the kernel's domain:
    1 <= k_cap <= min(C, ``MAX_K``), C <= ``MAX_CANDIDATES``.  Both checks
    come before the device's and before a kernel is loaded.

    Returns (vals (R, k_cap) f32 desc, idx (R, k_cap) i32, token (R,) i32).
    """
    global LAUNCHES
    if cand_v.dim() != 2:
        raise ValueError(f"cand_v: expected (R, C), got "
                         f"{tuple(cand_v.shape)}")
    r, c = cand_v.shape
    if k_cap < 1 or c % k_cap:
        raise ValueError(f"topk_sample merges runs of k_cap: C={c} is not "
                         f"a multiple of k_cap={k_cap}")
    if not k_cap <= min(c, MAX_K) or c > MAX_CANDIDATES:
        raise ValueError(f"topk_sample takes 1 <= k_cap <= min(C, {MAX_K}) "
                         f"and C <= {MAX_CANDIDATES}; got k_cap={k_cap}, "
                         f"C={c}")
    if cand_v.device.type != "cuda":
        raise ValueError(f"cand_v: expected a CUDA tensor, got "
                         f"{cand_v.device}")
    dev = cand_v.device
    _check(cand_v, "cand_v", (r, c), torch.float32, dev)
    _check(cand_i, "cand_i", (r, c), torch.int32, dev)
    if not greedy:
        _check(temp, "temperature", (r,), torch.float32, dev)
        _check(top_k, "top_k", (r,), torch.int32, dev)
        _check(top_p, "top_p", (r,), torch.float32, dev)
        _check(gumbel, "gumbel", (r, k_cap), torch.float32, dev)
    lib = _lib()
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
