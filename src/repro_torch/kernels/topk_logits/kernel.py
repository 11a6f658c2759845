"""Hopper kernels for top-k logit selection: build, binding and launch.

The CUDA source is ``kernels/csrc/topk_logits.cu`` (a warp per vocab
tile; its header says what it replaces and what bounds it).  It is built
by ``kernels/_build.py`` at first use and bound with ``ctypes``: pointers
and the current stream go in as integers, outputs are allocated here
with ``torch.empty``, and a launch error raises.

``fused_merge`` is the host's choice between one launch per call (a row's
tiles fit one block: stage 1 and the merge together) and two (stage 1,
then the merge); ``merge_fits`` says whether the merge takes a row of
candidates at all.

Width limit (a difference from the reference, which takes any k <= V):
the merge holds at most ``MAX_ENTRIES`` candidates in ``MAX_WARPS``
chunks of ``MAX_TILE``, so ``topk_logits_rows`` and
``topk_logits_merge`` raise ``ValueError`` beyond it: k <= 1,024 at the
AM's V = 3,183 (two 2,048-wide tiles) and k <= 218 at qwen2.5-3b's
V = 151,936 (75 tiles).  No path asks for more than k = 32.

``LAUNCHES`` counts kernel launches (fused, stage 1 and merge alike); it
is incremented only here, right after a launch that succeeded.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LAUNCHES = 0
MAX_TILE = 2048        # columns one warp holds (kMaxTile)
MAX_WARPS = 8          # warps of a row's block (kMaxWarps)
MAX_ENTRIES = 2048     # candidates one block merges (kMaxEntries)


def n_tiles(v: int, v_tile: int) -> int:
    return -(-v // v_tile)


def fused_merge(v: int, k: int, v_tile: int) -> bool:
    """Whether one launch takes a row of ``v`` logits in ``v_tile``-wide
    tiles to its top ``k``: its tiles fit one block's warps, and their
    candidates (``min(k, v_tile)`` a tile) the block's merge."""
    nt = n_tiles(v, v_tile)
    return nt <= MAX_WARPS and nt * min(k, v_tile) <= MAX_ENTRIES


def merge_fits(c: int, k: int) -> bool:
    """Whether the merge takes ``c`` candidates a row to ``k``: at most
    ``MAX_WARPS`` chunks of ``MAX_TILE``, whose winners fit the block's
    merge."""
    chunks = -(-c // MAX_TILE)
    return chunks <= MAX_WARPS and chunks * k <= MAX_ENTRIES


def _lib() -> ctypes.CDLL:
    lib = _build.load("topk_logits")
    if lib.topk_rows.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.topk_rows.argtypes = [p, p, p, ll, i, i, i, i, p]
        lib.topk_tiles.argtypes = [p, p, p, ll, i, i, i, p]
        lib.topk_merge.argtypes = [p, p, p, p, ll, i, i, p]
        for fn in (lib.topk_rows, lib.topk_tiles, lib.topk_merge):
            fn.restype = i
        lib.topk_error_string.argtypes = [i]
        lib.topk_error_string.restype = ctypes.c_char_p
    return lib


def _check(t: torch.Tensor, name: str, dtype: torch.dtype):
    if t.device.type != "cuda" or t.dtype != dtype or t.dim() != 2 \
            or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous 2-D CUDA {dtype} "
                         f"tensor, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def _launch(name: str, x: torch.Tensor, out_cols: int, call):
    """Allocate (rows, out_cols) outputs on ``x``'s card, launch
    ``call(lib, out_v, out_i, stream)`` (pointers as ints) and count
    it."""
    global LAUNCHES
    lib = _lib()
    out_v = torch.empty((x.shape[0], out_cols), dtype=torch.float32,
                        device=x.device)
    out_i = torch.empty((x.shape[0], out_cols), dtype=torch.int32,
                        device=x.device)
    with torch.cuda.device(x.device):
        err = call(lib, out_v.data_ptr(), out_i.data_ptr(),
                   torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           + lib.topk_error_string(err).decode())
    LAUNCHES += 1
    return out_v, out_i


def _check_tile(k: int, v_tile: int):
    if not 1 <= k <= v_tile <= MAX_TILE:
        raise ValueError(f"need 1 <= k <= v_tile <= {MAX_TILE}, got k={k}, "
                         f"v_tile={v_tile}")


def topk_logits_tiles(x: torch.Tensor, k: int, v_tile: int):
    """Stage 1: x (R, V) f32 -> per-tile candidates (R, nV*k) f32 + i32.

    Tiles are ``v_tile`` wide; the last tile's columns past V read as
    NEG (the reference pads with NEG), so no padded copy is made.
    """
    _check(x, "x", torch.float32)
    _check_tile(k, v_tile)
    r, v = x.shape
    return _launch("topk_tiles", x, n_tiles(v, v_tile) * k,
                   lambda lib, ov, oi, st: lib.topk_tiles(
                       x.data_ptr(), ov, oi, r, v, v_tile, k, st))


def topk_logits_rows(x: torch.Tensor, k: int, v_tile: int):
    """Stage 1 and the merge in one launch: x (R, V) f32 -> the row's
    top-k (R, k) f32 + i32, from ``min(k, v_tile)`` candidates a tile.
    Needs ``fused_merge(V, k, v_tile)``."""
    _check(x, "x", torch.float32)
    kt = min(k, v_tile)
    _check_tile(kt, v_tile)
    v = x.shape[1]
    if not 1 <= k <= v or not fused_merge(v, k, v_tile):
        raise ValueError(f"one launch takes V <= {MAX_WARPS} tiles and at "
                         f"most {MAX_ENTRIES} candidates, k <= V; got V={v}"
                         f", k={k}, v_tile={v_tile}")
    return _launch("topk_rows", x, k,
                   lambda lib, ov, oi, st: lib.topk_rows(
                       x.data_ptr(), ov, oi, x.shape[0], v, v_tile, kt, k,
                       st))


def topk_logits_merge(cand_v: torch.Tensor, cand_i: torch.Tensor, k: int):
    """Stage 2: candidates (R, C) -> global top-k (R, k) f32 + i32.

    Ties go to the smallest candidate position; ids are read through
    ``cand_i``.
    """
    _check(cand_v, "cand_v", torch.float32)
    _check(cand_i, "cand_i", torch.int32)
    c = cand_v.shape[1]
    if cand_v.shape != cand_i.shape or not 1 <= k <= c or \
            not merge_fits(c, k):
        raise ValueError(f"bad merge shapes {tuple(cand_v.shape)}, "
                         f"{tuple(cand_i.shape)} for k={k} (at most "
                         f"{MAX_WARPS} chunks of {MAX_TILE} candidates, "
                         f"chunks * k <= {MAX_ENTRIES})")
    return _launch("topk_merge", cand_v, k,
                   lambda lib, ov, oi, st: lib.topk_merge(
                       cand_v.data_ptr(), cand_i.data_ptr(), ov, oi,
                       cand_v.shape[0], c, k, st))
