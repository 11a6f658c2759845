"""Gradient Threshold Compression (paper §2/§3.5; Strom, Interspeech 2015).

The paper's 16-GPU trainer for labeled CE + sMBR, and the default
student trainer.  Strom's algorithm, kept bit-faithful:

  r      <- r + g                      (error-feedback residual)
  send   <- tau * sign(r) * [|r| > tau]   (1-bit-quantized sparse message)
  r      <- r - send
  update <- sum_over_workers(send)

``compress_tree`` is the error-feedback selection, run per leaf through
``kernels/gtc_compress`` (the Hopper kernel on a CUDA tensor, its plain
version on a CPU tensor); ``pack_int8`` / ``unpack_int8`` are the only
pack/unpack pair; ``wire_reduce`` is the wire.  At one worker the int8
wire is a pack/unpack round-trip that is a bitwise identity on ternary
sends, so the single-process ``train.GTC`` strategy runs the exact
arithmetic of the multi-worker wire.

A tree is a dict of tensors (a state dict).  Every function here walks
it in the reference's leaf order (``utils.trees.leaf_order``).  The
multi-worker steps over a process group, ``simulate_gtc_round`` and
``adaptive_tau`` are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from repro_torch.kernels.gtc_compress import gtc_compress
from repro_torch.utils.trees import leaf_order

Tree = Dict[str, torch.Tensor]

MAX_INT8_WORKERS = 127       # |sum of W ternary messages| <= W must fit int8


@dataclass(frozen=True)
class GTCConfig:
    tau: float = 1e-3
    quantize_int8: bool = True       # pack the send tensor to int8 on the wire
    n_workers: int = 16
    int32_accum: bool = False        # widen the sum to int32 (required
                                     # beyond 127 workers; the narrow int8
                                     # wire is exact below that)
    use_kernel: Optional[bool] = None    # None: the Hopper kernel on a
                                         # CUDA tensor, the plain version
                                         # on a CPU tensor


# ----------------------------------------------------------- compression

def compress_leaf(g: torch.Tensor, r: torch.Tensor, tau: float, *,
                  use_kernel: Optional[bool] = None):
    """One tensor: error-feedback threshold compression.

    Returns (send, new_residual), float32; send has values in
    {-tau, 0, +tau}.  Kernel and plain version are bitwise-identical.
    """
    return gtc_compress(g, r, tau, use_kernel=use_kernel)


def compress_tree(grads: Tree, residuals: Tree, tau: float, *,
                  use_kernel: Optional[bool] = None):
    """(sends, new_residuals) over every leaf, in the reference's leaf
    order."""
    sends, ress = {}, {}
    for n in leaf_order(grads):
        sends[n], ress[n] = compress_leaf(grads[n], residuals[n], tau,
                                          use_kernel=use_kernel)
    return sends, ress


# ------------------------------------------------------------------ wire

def pack_int8(send: torch.Tensor, tau: float, *, n_workers: int = 1,
              int32_accum: bool = False) -> torch.Tensor:
    """{-tau,0,tau} -> int8 {-1,0,1}: the wire format (4x smaller than
    f32).

    ``n_workers`` is the number of ternary messages the reduction will
    sum.  At int8 width the sum is exact only while ``n_workers <= 127``;
    past that the packed wire would silently wrap, so this raises unless
    the caller opted into int32 accumulation.
    """
    if n_workers > MAX_INT8_WORKERS and not int32_accum:
        raise ValueError(
            f"pack_int8: summing {n_workers} ternary int8 messages "
            f"overflows int8 (|sum| <= {n_workers} > {MAX_INT8_WORKERS}); "
            f"set int32_accum=True to widen the accumulation")
    return torch.clamp(torch.round(send / tau), -1, 1).to(torch.int8)


def unpack_int8(packed: torch.Tensor, tau: float,
                n_workers_summed: int = 1) -> torch.Tensor:
    """Packed (possibly summed) wire integers -> the averaged float
    update: ``packed * tau / n_workers_summed``.  With
    ``n_workers_summed=1`` this is the exact inverse of ``pack_int8`` on
    a single message."""
    out = packed.float() * tau
    if n_workers_summed != 1:
        out = out / n_workers_summed
    return out


def wire_pack(send: torch.Tensor, cfg: GTCConfig) -> torch.Tensor:
    """One worker's send tensor -> its wire message: ternary int8 (or
    int32-widened when ``cfg.int32_accum``), or the raw f32 send when the
    wire is unquantized."""
    if not cfg.quantize_int8:
        return send
    p = pack_int8(send, cfg.tau, n_workers=cfg.n_workers,
                  int32_accum=cfg.int32_accum)
    return p.to(torch.int32) if cfg.int32_accum else p


def wire_unpack(acc: torch.Tensor, cfg: GTCConfig) -> torch.Tensor:
    """Accumulated wire messages -> the averaged float update."""
    if cfg.quantize_int8:
        return unpack_int8(acc, cfg.tau, n_workers_summed=cfg.n_workers)
    return acc / cfg.n_workers if cfg.n_workers != 1 else acc


def wire_reduce(sends: Tree, cfg: GTCConfig) -> Tree:
    """The wire for one worker: pack -> unpack-average, per leaf.  At
    ``cfg.n_workers == 1`` with the int8 format this is a bitwise
    identity on ternary sends.  Returns the update averaged over
    ``cfg.n_workers`` (the paper applies the raw sum; normalizing keeps
    the learning rate worker-count independent)."""
    return {n: wire_unpack(wire_pack(sends[n], cfg), cfg)
            for n in leaf_order(sends)}


def gtc_init(params: Tree, cfg: Optional[GTCConfig] = None) -> dict:
    """Error-feedback residuals, zeros in float32.  With a ``cfg`` they
    are per-worker: stacked on a leading W dim, even at W=1.  Without
    one, the single-process unstacked form."""
    lead = () if cfg is None else (cfg.n_workers,)
    return {"residual": {n: torch.zeros(lead + tuple(params[n].shape),
                                        dtype=torch.float32,
                                        device=params[n].device)
                         for n in leaf_order(params)}}


def density(update: Tree, tau: float) -> torch.Tensor:
    """Fraction of nonzero elements actually shipped (diagnostic), a
    float32 scalar on the update's device."""
    del tau                                  # the reference's signature
    names = leaf_order(update)
    nz = sum((update[n].abs() > 0).sum().float() for n in names)
    n = sum(update[n].numel() for n in names)
    return nz / max(n, 1)
