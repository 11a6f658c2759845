"""Hopper kernel for the fused logsumexp + top-k gather: build, binding
and launch.

The CUDA source is ``kernels/csrc/sparse_ce.cu`` (its header says what it
replaces, what bounds it and its shared-memory and register budget): a
tile kernel that computes ``h @ w`` as 3xTF32 ``wgmma`` in its own body
and writes per-tile (max, sum-exp) partials and the gathered logits, then
a merge kernel that turns the partials into the logsumexp -- two launches
a call.  ``ref.sparse_ce_tiled_ref`` is the tile kernel's arithmetic on
the host.  It is built by ``kernels/_build.py`` at first use and bound
with ``ctypes``: outputs and the partials' scratch are allocated here
with ``torch.empty``, and a launch error raises.

``LAUNCHES`` counts kernel launches (tiles and merge alike); it is
incremented only here, right after a launch that succeeded.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LAUNCHES = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("sparse_ce")
    if lib.sparse_ce_tiles.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.sparse_ce_tiles.argtypes = [p, p, p, p, p, p, i, i, i, i,
                                        ctypes.c_float, p]
        lib.sparse_ce_tiles.restype = ctypes.c_int
        lib.sparse_ce_merge.argtypes = [p, p, p, i, i, p]
        lib.sparse_ce_merge.restype = ctypes.c_int
        lib.sparse_ce_tile_cols.argtypes = []
        lib.sparse_ce_tile_cols.restype = ctypes.c_int
        lib.sparse_ce_error_string.argtypes = [i]
        lib.sparse_ce_error_string.restype = ctypes.c_char_p
    return lib


def _check(t: torch.Tensor, name: str, dtype: torch.dtype):
    if t.device.type != "cuda" or t.dtype != dtype or t.dim() != 2 \
            or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous 2-D CUDA {dtype} "
                         f"tensor, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def _launched(lib, err: int, what: str):
    global LAUNCHES
    if err:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.sparse_ce_error_string(err).decode())
    LAUNCHES += 1


def sparse_ce_tiles(h: torch.Tensor, w: torch.Tensor, idx: torch.Tensor,
                    softcap: float = 0.0):
    """h (T,D) f32, w (D,V) f32, idx (T,K) i32, all contiguous on one
    card -> (lse (T,) f32, gathered (T,K) f32).  Columns past V are
    masked inside the kernel: no padded copy of w."""
    _check(h, "h", torch.float32)
    _check(w, "w", torch.float32)
    _check(idx, "idx", torch.int32)
    t, d = h.shape
    v = w.shape[1]
    k = idx.shape[1]
    if w.shape[0] != d or idx.shape[0] != t:
        raise ValueError(f"shapes h {tuple(h.shape)}, w {tuple(w.shape)}, "
                         f"idx {tuple(idx.shape)} do not chain")
    if not h.device == w.device == idx.device:
        raise ValueError("h, w and idx must be on one device")
    lib = _lib()
    n_vt = -(-v // lib.sparse_ce_tile_cols())
    lse = torch.empty((t,), dtype=torch.float32, device=h.device)
    z = torch.empty((t, k), dtype=torch.float32, device=h.device)
    if t == 0:
        return lse, z
    part_m = torch.empty((t, n_vt), dtype=torch.float32, device=h.device)
    part_l = torch.empty_like(part_m)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        _launched(lib, lib.sparse_ce_tiles(
            h.data_ptr(), w.data_ptr(), idx.data_ptr(), part_m.data_ptr(),
            part_l.data_ptr(), z.data_ptr(), t, d, v, k, float(softcap),
            stream), "sparse_ce_tiles")
        _launched(lib, lib.sparse_ce_merge(
            part_m.data_ptr(), part_l.data_ptr(), lse.data_ptr(), t, n_vt,
            stream), "sparse_ce_merge")
    return lse, z
