"""Hopper kernels for causal sliding-window attention over a whole
sequence: build, binding and launch.

The CUDA source is ``kernels/csrc/swa_attention.cu`` (its header says
what it replaces, its tensor-core design and what bounds it).  It is
built by ``kernels/_build.py`` at first use and bound with ``ctypes``:
pointers, the shapes, the static knobs and the current stream go in;
the key images and the output are allocated here with ``torch.empty``,
and a launch error raises.

A call is two launches: the prepass (``swa_split_kv``), which writes k
and v once as the main loop's shared-memory images (split into TF32 big
and small halves, v transposed), and the main kernel: masked by index
over the band's key tiles, or, given positions (the causal branch
only), by them over every key tile.

``LAUNCHES`` counts kernel launches, two a call; it is incremented only
here, right after each launch that succeeded.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

LAUNCHES = 0
Q_TILE = 64          # query rows per block (kTq in the source): the band
                     # of the tile at q0 is [q0 - window + 1, q0 + Q_TILE)


def _lib() -> ctypes.CDLL:
    lib = _build.load("swa_attention")
    if lib.swa_attention.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.swa_attention_split_kv.argtypes = [p, p, p, i, i, i, i, i, p]
        lib.swa_attention_split_kv.restype = i
        lib.swa_attention.argtypes = [p, p, p, p, i, i, i, i, i, i, i, f, f,
                                      p]
        lib.swa_attention.restype = i
        lib.swa_attention_scratch_floats.argtypes = [i, i, i, i]
        lib.swa_attention_scratch_floats.restype = ctypes.c_longlong
        lib.swa_attention_error_string.argtypes = [i]
        lib.swa_attention_error_string.restype = ctypes.c_char_p
        lib.swa_attention_max_head_dim.argtypes = []
        lib.swa_attention_max_head_dim.restype = i
    return lib


def _check(t: torch.Tensor, name: str, shape, dtypes, device):
    if t.device != device or t.dtype not in dtypes or \
            tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {tuple(shape)} "
                         f"tensor of {dtypes} on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device} (contiguous: "
                         f"{t.is_contiguous()})")


def swa_attention_tiles(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, window: int, scale: float, softcap: float,
                        positions: Optional[torch.Tensor] = None):
    """q (B, Hq, S, hd), k and v (B, Hkv, S, hd), one dtype, f32 or bf16,
    contiguous, Hq a multiple of Hkv.  Key j is visible to query i iff
    ``i - window < j <= i``; with ``positions`` (S,) int32, contiguous,
    on q's device (window >= S only), iff ``pos[i] >= 0 and pos[j] <=
    pos[i]``, every key tile visited.  Returns o (B, Hq, S, hd) f32."""
    global LAUNCHES
    if q.device.type != "cuda" or q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q, k: expected 4-D CUDA tensors, got "
                         f"{tuple(q.shape)} on {q.device}, "
                         f"{tuple(k.shape)}")
    b, hq, s, hd = q.shape
    hkv = k.shape[1]
    dev = q.device
    dts = (torch.float32, torch.bfloat16)
    _check(q, "q", (b, hq, s, hd), dts, dev)
    _check(k, "k", (b, hkv, s, hd), (q.dtype,), dev)
    _check(v, "v", (b, hkv, s, hd), (q.dtype,), dev)
    if positions is not None:
        _check(positions, "positions", (s,), (torch.int32,), dev)
        if int(window) < s:
            raise ValueError(f"positions mask the causal branch only "
                             f"(window >= S); got window {window} < S {s}")
    lib = _lib()
    if hkv < 1 or hq % hkv or hd > lib.swa_attention_max_head_dim() or \
            int(window) < 1 or b * hkv > 65535:
        raise ValueError(f"swa_attention takes Hq a multiple of Hkv, hd <= "
                         f"{lib.swa_attention_max_head_dim()}, window >= 1 "
                         f"and B*Hkv <= 65535; got Hq={hq}, Hkv={hkv}, "
                         f"hd={hd}, window={window}, B={b}")
    bf16 = int(q.dtype == torch.bfloat16)
    out = torch.empty((b, hq, s, hd), dtype=torch.float32, device=dev)
    if b == 0 or s == 0:
        return out
    img = torch.empty(int(lib.swa_attention_scratch_floats(b, hkv, s, hd)),
                      dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.swa_attention_split_kv(k.data_ptr(), v.data_ptr(),
                                         img.data_ptr(), b, hkv, s, hd, bf16,
                                         stream)
        _raise("swa_attention_split_kv", lib, err)
        LAUNCHES += 1
        err = lib.swa_attention(q.data_ptr(), img.data_ptr(), out.data_ptr(),
                                None if positions is None
                                else positions.data_ptr(),
                                b, hq, hkv, s, hd, bf16, int(window),
                                float(scale), float(softcap), stream)
        _raise("swa_attention", lib, err)
        LAUNCHES += 1
    return out


def _raise(name: str, lib: ctypes.CDLL, err: int):
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           + lib.swa_attention_error_string(err).decode())
