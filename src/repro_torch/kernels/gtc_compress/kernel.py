"""Hopper kernel for GTC threshold compression: build, binding and launch.

The CUDA source is ``kernels/csrc/gtc_compress.cu`` (its header says
what it replaces and what bounds it).  It is built by
``kernels/_build.py`` at first use and bound with ``ctypes``: pointers,
the element count, tau as a float32 and the current stream go in;
outputs are allocated here with ``torch.empty``, and a launch error
raises.

``LAUNCHES`` counts kernel launches; it is incremented only here, right
after a launch that succeeded.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LAUNCHES = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("gtc_compress")
    if lib.gtc_compress.argtypes is None:
        p = ctypes.c_void_p
        lib.gtc_compress.argtypes = [p, p, p, p, ctypes.c_longlong,
                                     ctypes.c_float, p]
        lib.gtc_compress.restype = ctypes.c_int
        lib.gtc_error_string.argtypes = [ctypes.c_int]
        lib.gtc_error_string.restype = ctypes.c_char_p
    return lib


def _check(t: torch.Tensor, name: str):
    if t.device.type != "cuda" or t.dtype != torch.float32 \
            or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous CUDA float32 "
                         f"tensor, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def gtc_compress_flat(grad: torch.Tensor, residual: torch.Tensor,
                      tau: float):
    """grad, residual: contiguous f32 CUDA tensors of one shape (any
    length: no padding); tau >= 0.  -> (send, new_residual), same shape."""
    global LAUNCHES
    _check(grad, "grad")
    _check(residual, "residual")
    if grad.shape != residual.shape or grad.device != residual.device:
        raise ValueError(f"grad {tuple(grad.shape)} on {grad.device} and "
                         f"residual {tuple(residual.shape)} on "
                         f"{residual.device} differ")
    lib = _lib()
    send = torch.empty_like(grad)
    new_r = torch.empty_like(grad)
    with torch.cuda.device(grad.device):
        err = lib.gtc_compress(
            grad.data_ptr(), residual.data_ptr(), send.data_ptr(),
            new_r.data_ptr(), grad.numel(), tau,
            torch.cuda.current_stream(grad.device).cuda_stream)
    if err:
        raise RuntimeError("gtc_compress launch failed: "
                           + lib.gtc_error_string(err).decode())
    LAUNCHES += 1
    return send, new_r
