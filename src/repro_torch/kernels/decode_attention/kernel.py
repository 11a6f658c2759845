"""Hopper kernel for single-token decode attention: build, binding and
launch.

The CUDA source is ``kernels/csrc/decode_attention.cu`` (its header says
what it replaces, its split-S design and what bounds it).  It is built
by ``kernels/_build.py`` at first use and bound with ``ctypes``:
pointers, the shapes, the static knobs, the device and its current
stream go in; the output is allocated here with ``torch.empty``; the
caches are written in place, and a launch error raises.

``split_plan`` is the host half of the split: how many blocks (one
thread-block cluster) share one (row, kv head).

``LAUNCHES`` counts kernel launches; it is incremented only here, right
after a launch that succeeded.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.kernels import _build

LAUNCHES = 0
TILE = 64              # cache slots per tile of the kernel (kTile)
MAX_SPLIT = 8          # blocks per (row, kv head) at most: a portable
                       # cluster (kMaxSplit)
BLOCKS_PER_SM = 2      # the grid the plan aims for, per SM
H100_SMS = 132

_SMS: Dict[torch.device, int] = {}


def split_plan(bh: int, s: int, sms: int = H100_SMS) -> int:
    """Blocks per (row, kv head) for ``bh`` = B * Hkv pairs over an
    ``s``-slot cache: enough to put ``BLOCKS_PER_SM`` blocks on each of
    ``sms`` SMs, but no more than one per ``TILE`` slots of the cache
    (a chunk shorter than a tile only adds a partial to combine) and no
    more than ``MAX_SPLIT``.  1 means no partials and no combine."""
    want = -(-BLOCKS_PER_SM * sms // max(bh, 1))
    return max(1, min(want, -(-s // TILE), MAX_SPLIT))


def _sms(device: torch.device) -> int:
    n = _SMS.get(device)
    if n is None:
        n = _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    if lib.decode_attention.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.decode_attention.argtypes = [p, p, p, p, p, p, p, p, p,
                                         i, i, i, i, i, i, i, i, f, f, i, i,
                                         i, i, p]
        lib.decode_attention.restype = i
        lib.decode_attention_error_string.argtypes = [i]
        lib.decode_attention_error_string.restype = ctypes.c_char_p
        for fn in (lib.decode_attention_max_group,
                   lib.decode_attention_max_head_dim):
            fn.argtypes = []
            fn.restype = i
    return lib


def _check(t: torch.Tensor, name: str, shape, dtypes, device):
    if t.device != device or t.dtype not in dtypes or \
            tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {tuple(shape)} "
                         f"tensor of {dtypes} on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def decode_attention_tiles(q: torch.Tensor, k_new: torch.Tensor,
                           v_new: torch.Tensor, cache_k: torch.Tensor,
                           cache_v: torch.Tensor, pos: torch.Tensor,
                           cos: Optional[torch.Tensor],
                           sin: Optional[torch.Tensor], *, window: int,
                           scale: float, softcap: float, write: bool):
    """q (B, Hkv, G, hd) f32; k_new, v_new (B, Hkv, hd) f32; cache_k,
    cache_v (B, Hkv, S, hd) bf16 or f32, written in place at slot
    ``pos % S`` when ``write``; pos (B,) i32; cos, sin (B, hd/2) f32, or
    None for no rotation.  A row at ``pos < 0`` writes nothing and, every
    slot masked, returns the mean of its S value rows, as the plain
    version does (the kernel reads pos on the card, so nothing here
    waits to check it).  B * Hkv <= 65535 (the
    grid's second axis).  Returns o (B, Hkv, G, hd) f32."""
    global LAUNCHES
    if q.device.type != "cuda" or q.dim() != 4:
        raise ValueError(f"q: expected a 4-D CUDA tensor, got "
                         f"{tuple(q.shape)} on {q.device}")
    b, hkv, g, hd = q.shape
    s = cache_k.shape[2] if cache_k.dim() == 4 else -1
    dev = q.device
    f32, cdt = (torch.float32,), (torch.bfloat16, torch.float32)
    _check(q, "q", (b, hkv, g, hd), f32, dev)
    _check(k_new, "k_new", (b, hkv, hd), f32, dev)
    _check(v_new, "v_new", (b, hkv, hd), f32, dev)
    _check(cache_k, "cache_k", (b, hkv, s, hd), cdt, dev)
    _check(cache_v, "cache_v", (b, hkv, s, hd), (cache_k.dtype,), dev)
    _check(pos, "pos", (b,), (torch.int32,), dev)
    rope = cos is not None
    if rope:
        _check(cos, "cos", (b, hd // 2), f32, dev)
        _check(sin, "sin", (b, hd // 2), f32, dev)
    lib = _lib()
    if g > lib.decode_attention_max_group() or hd % 2 or \
            hd > lib.decode_attention_max_head_dim() or s < 1 or \
            b * hkv > 65535:
        raise ValueError(f"decode_attention takes G <= "
                         f"{lib.decode_attention_max_group()}, an even "
                         f"hd <= {lib.decode_attention_max_head_dim()}, "
                         f"S >= 1 and B*Hkv <= 65535; got G={g}, hd={hd}, "
                         f"S={s}, B*Hkv={b * hkv}")
    nsplit = split_plan(b * hkv, s, _sms(dev))
    out = torch.empty((b, hkv, g, hd), dtype=torch.float32, device=dev)
    row_bytes = hd * cache_k.element_size()
    vec = row_bytes % 16 == 0 and cache_k.data_ptr() % 16 == 0 and \
        cache_v.data_ptr() % 16 == 0
    err = lib.decode_attention(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        cache_k.data_ptr(), cache_v.data_ptr(), pos.data_ptr(),
        cos.data_ptr() if rope else None,
        sin.data_ptr() if rope else None, out.data_ptr(),
        b, hkv, g, s, hd, nsplit, int(cache_k.dtype == torch.bfloat16),
        int(window), float(scale), float(softcap), int(rope), int(write),
        int(vec), dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError("decode_attention launch failed: "
                           + lib.decode_attention_error_string(err).decode())
    LAUNCHES += 1
    return out
