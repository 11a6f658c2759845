"""Shared building blocks: initializers, norms, MLPs, RoPE, embeddings.

Params are float32; norm statistics are taken in float32 whatever the
input dtype.  Random draws come from an explicit ``torch.Generator`` on
the generator's own device and are then moved to the target device: a
CPU generator gives the same weights on the host and on the card, a CUDA
one draws a large model on the card without a host round trip (other
numbers from the same seed).
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F


def _normal(shape, generator: Optional[torch.Generator], device):
    """N(0, 1) float32 drawn from ``generator`` on its device, then
    moved; with ``generator=None`` (only on the meta device) an empty
    shape template."""
    if generator is None:
        if torch.device(device).type != "meta":
            raise ValueError("random init needs an explicit generator")
        return torch.empty(shape, device=device)
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=generator.device).to(device)


def dense_init(fan_in: int, fan_out: int, *,
               generator: Optional[torch.Generator],
               device="cpu") -> torch.Tensor:
    """(fan_in, fan_out) float32 weight ~ N(0, 1 / fan_in), applied as
    ``x @ w`` (the reference's layout, no transpose)."""
    if generator is None:
        return _normal((fan_in, fan_out), None, device)
    # scaled where drawn: the card may divide by a scalar through its
    # reciprocal, and one CPU seed must give the same weights everywhere
    w = _normal((fan_in, fan_out), generator, generator.device)
    return (w / math.sqrt(max(fan_in, 1))).to(device)


def embed_init(vocab: int, d: int, *, generator: Optional[torch.Generator],
               device) -> torch.Tensor:
    """(vocab, d) float32 table ~ N(0, 1)."""
    return _normal((vocab, d), generator, device)


# ---------------------------------------------------------------- norms

def norm_init(d: int, kind: str, *, device) -> Dict[str, torch.Tensor]:
    """RMSNorm holds ``scale`` applied as ``(1 + scale)`` (zeros at
    init); LayerNorm holds ``scale`` and ``bias``."""
    if kind == "rmsnorm":
        return {"scale": torch.zeros((d,), device=device)}
    return {"scale": torch.ones((d,), device=device),
            "bias": torch.zeros((d,), device=device)}


def norm_apply(params: Mapping[str, torch.Tensor], x: torch.Tensor,
               kind: str, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        var = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * (1.0 + params["scale"])
    else:
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps) * params["scale"] \
            + params["bias"]
    return y.to(x.dtype)


def rms_head_norm(scale: torch.Tensor, x: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """Per-head qk-norm over the last (head_dim) axis."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale)).to(x.dtype)


# ---------------------------------------------------------------- mlp

def act_fn(name: str):
    # jax.nn.gelu defaults to the tanh approximation
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


def mlp_init(d: int, d_ff: int, *, gated: bool = True,
             generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
    p = {"up": dense_init(d, d_ff, generator=generator, device=device)}
    if gated:
        p["gate"] = dense_init(d, d_ff, generator=generator, device=device)
    p["down"] = dense_init(d_ff, d, generator=generator, device=device)
    return p


def mlp_apply(params: Mapping[str, torch.Tensor], x: torch.Tensor,
              act: str) -> torch.Tensor:
    h = x @ params["up"].to(x.dtype)
    if "gate" in params:
        h = act_fn(act)(x @ params["gate"].to(x.dtype)) * h
    else:
        h = act_fn(act)(h)
    return h @ params["down"].to(x.dtype)


# ---------------------------------------------------------------- rope

_INV_FREQ: Dict[tuple, torch.Tensor] = {}


def _inv_freq(dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """The inverse-frequency table, computed in numpy float32 exactly as
    the reference computes it, uploaded once per (dim, theta, device) so
    a decode step copies nothing from the host."""
    key = (dim, float(theta), str(device))
    t = _INV_FREQ.get(key)
    if t is None:
        inv = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
        t = _INV_FREQ[key] = torch.from_numpy(
            np.asarray(inv, np.float32)).to(device)
    return t


def rope_tables(positions: torch.Tensor, dim: int, theta: float):
    """positions (...,) int -> cos/sin (..., dim/2) float32."""
    inv = _inv_freq(dim, theta, positions.device)
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, dim); cos/sin broadcastable (..., S, dim/2). Paired
    halves, rotated in float32."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2].float(), x[..., d2:].float()
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    return torch.cat([o1, o2], dim=-1).to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return torch.tanh(x / cap) * cap
