"""Shared device and backend dispatch for every kernel subpackage.

The twin of the reference's ``kernels/_dispatch.py``, with one knob:

  ``use_kernel`` — whether a wrapper launches its Hopper kernel.
    ``None`` (the default everywhere) decides by where the tensor lies:
    the kernel for a CUDA tensor, the plain PyTorch version for a CPU
    tensor.  There is no silent fallback: a CUDA device below compute
    capability 9.0 raises, ``use_kernel=True`` on a CPU tensor raises,
    and ``use_kernel=False`` on a CUDA tensor raises (the plain versions
    run on the card only where ``chip_smoke.py`` calls ``ref.py``
    directly to hold a kernel against it).

``resolve_device`` is the entry points' device rule: ``"cuda"`` unless
the caller passes another device, and an error — not the CPU — when
CUDA is absent.
"""
from __future__ import annotations

from typing import Optional

import torch

MIN_CAPABILITY = (9, 0)       # the kernels are built for sm_90a


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default; raises if
    CUDA is asked for (explicitly or by default) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the host")
    return dev


_CHECKED = set()               # devices found to be sm_90 or newer


def check_capability(device: torch.device):
    """Raise below sm_90; a device that passed is not asked again (the
    query costs a few microseconds on every kernel call otherwise)."""
    if device in _CHECKED:
        return
    cap = torch.cuda.get_device_capability(device)
    if cap < MIN_CAPABILITY:
        raise RuntimeError(
            f"{torch.cuda.get_device_name(device)} has compute capability "
            f"{cap[0]}.{cap[1]}; the kernels need sm_90a (Hopper, >= 9.0)")
    _CHECKED.add(device)


def auto_use_kernel(x: torch.Tensor, use_kernel: Optional[bool] = None
                    ) -> bool:
    """Resolve ``use_kernel`` for tensor ``x``: the Hopper kernel on a
    CUDA tensor, the plain version on a CPU tensor, an error otherwise."""
    if x.device.type == "cuda":
        if use_kernel is False:
            raise ValueError("use_kernel=False on a CUDA tensor: the plain "
                             "version runs only on CPU tensors")
        check_capability(x.device)
        return True
    if x.device.type == "cpu":
        if use_kernel:
            raise ValueError("use_kernel=True needs a CUDA tensor")
        return False
    raise ValueError(f"no kernel or plain path for device {x.device}")
