"""Hopper kernel for top-k logit selection: build, binding and launch.

The CUDA source is ``kernels/csrc/topk_logits.cu`` (one kernel for both
stages; its header says what it replaces and what bounds it).  It is
built by ``kernels/_build.py`` at first use and bound with ``ctypes``:
pointers and the current stream go in as integers, outputs are allocated
here with ``torch.empty``, and a launch error raises.

``LAUNCHES`` counts kernel launches (stage 1 and merge alike); it is
incremented only here, right after a launch that succeeded.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LAUNCHES = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("topk_logits")
    if lib.topk_select.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.topk_select.argtypes = [p, p, p, p, ctypes.c_longlong,
                                    i, i, i, i, p]
        lib.topk_select.restype = ctypes.c_int
        lib.topk_error_string.argtypes = [i]
        lib.topk_error_string.restype = ctypes.c_char_p
        lib.topk_max_tile.argtypes = []
        lib.topk_max_tile.restype = ctypes.c_int
    return lib


def _check(t: torch.Tensor, name: str, dtype: torch.dtype):
    if t.device.type != "cuda" or t.dtype != dtype or t.dim() != 2 \
            or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous 2-D CUDA {dtype} "
                         f"tensor, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def _select(x, ids, out_cols: int, tile: int, n_tiles: int, k: int):
    global LAUNCHES
    lib = _lib()
    if tile > lib.topk_max_tile():
        raise ValueError(f"tile {tile} > {lib.topk_max_tile()} columns, "
                         "the most one block holds")
    rows, n_cols = x.shape
    out_v = torch.empty((rows, out_cols), dtype=torch.float32,
                        device=x.device)
    out_i = torch.empty((rows, out_cols), dtype=torch.int32,
                        device=x.device)
    with torch.cuda.device(x.device):
        err = lib.topk_select(
            x.data_ptr(), None if ids is None else ids.data_ptr(),
            out_v.data_ptr(), out_i.data_ptr(), rows, n_cols, tile,
            n_tiles, k, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError("topk_select launch failed: "
                           + lib.topk_error_string(err).decode())
    LAUNCHES += 1
    return out_v, out_i


def topk_logits_tiles(x: torch.Tensor, k: int, v_tile: int):
    """Stage 1: x (R, V) f32 -> per-tile candidates (R, nV*k) f32 + i32.

    Tiles are ``v_tile`` wide; the last tile's columns past V read as
    NEG (the reference pads with NEG), so no padded copy is made.
    """
    _check(x, "x", torch.float32)
    if not 1 <= k <= v_tile:
        raise ValueError(f"need 1 <= k <= v_tile, got k={k}, "
                         f"v_tile={v_tile}")
    n_tiles = -(-x.shape[1] // v_tile)
    return _select(x, None, n_tiles * k, v_tile, n_tiles, k)


def topk_logits_merge(cand_v: torch.Tensor, cand_i: torch.Tensor, k: int):
    """Stage 2: candidates (R, C) -> global top-k (R, k) f32 + i32.

    Ties go to the smallest candidate position; ids are read through
    ``cand_i``.
    """
    _check(cand_v, "cand_v", torch.float32)
    _check(cand_i, "cand_i", torch.int32)
    if cand_v.shape != cand_i.shape or not 1 <= k <= cand_v.shape[1]:
        raise ValueError(f"bad merge shapes {tuple(cand_v.shape)}, "
                         f"{tuple(cand_i.shape)} for k={k}")
    c = cand_v.shape[1]
    return _select(cand_v, cand_i, k, c, 1, k)
