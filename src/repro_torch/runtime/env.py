"""Computation-environment bootstrap -- applied before the first CUDA
initialization.

The twin of the reference's ``runtime/env.py`` for torch.  The reference
composes XLA flags before ``import jax``; torch has no such client
configuration, so of the same ``REPRO_*`` knobs this applies what has a
torch meaning, and entry points call :func:`bootstrap_from_env` as their
first statement (``launch/train.py``):

* ``REPRO_PLATFORM=cpu|gpu`` -- the entry points' device (``cpu`` or
  ``cuda``; :attr:`EnvConfig.device`), where the reference sets
  ``JAX_PLATFORMS``; ``tpu`` has no torch path and raises;
* ``REPRO_PREALLOCATE=0|1`` -- the caching allocator's segments
  (``PYTORCH_CUDA_ALLOC_CONF``: ``expandable_segments:True`` grows one
  mapping in place instead of reserving blocks, the closest torch has to
  XLA's preallocation switched off), read at the first CUDA allocation;
* ``REPRO_DEBUG_NANS=0|1`` -- autograd's anomaly detection, which raises
  at the backward op that produced a NaN.

``REPRO_HOST_DEVICES=N`` splits one CPU into N XLA devices in the
reference; torch has no such split, and the port's way to more than one
worker device is ``--cluster`` with N gloo ranks, so N > 0 raises and
says so.  ``REPRO_X64`` and ``REPRO_XLA_FLAGS`` have no torch meaning:
they are read, left in the environment and shown by :func:`describe`.

:func:`describe` snapshots the resulting environment (torch and CUDA
versions, devices, the card's name and power limit from ``nvidia-smi``,
rank and world size, the ``REPRO_*`` variables), the first thing to diff
when two ranks of a fleet disagree.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from dataclasses import dataclass, field
from typing import Mapping, MutableMapping, Optional, Tuple

_PLATFORMS = {"": "", "cpu": "cpu", "gpu": "cuda", "cuda": "cuda"}


@dataclass(frozen=True)
class EnvConfig:
    """What :func:`bootstrap` applies.  Zero/None means "leave alone"."""

    host_device_count: int = 0        # >0 raises: use --cluster N
    platform: str = ""                # "", "cpu", "gpu"
    enable_x64: Optional[bool] = None
    debug_nans: Optional[bool] = None
    preallocate: Optional[bool] = None
    extra_xla_flags: Tuple[str, ...] = field(default_factory=tuple)

    @classmethod
    def from_env(cls, environ: Optional[Mapping[str, str]] = None
                 ) -> "EnvConfig":
        """REPRO_* knobs -> EnvConfig (unset knobs stay neutral): the
        reference's names and parsing."""
        e = os.environ if environ is None else environ

        def _bool(name):
            v = e.get(name)
            return None if v is None else v.strip().lower() in (
                "1", "true", "yes", "on")

        return cls(
            host_device_count=int(e.get("REPRO_HOST_DEVICES", 0) or 0),
            platform=e.get("REPRO_PLATFORM", "").strip().lower(),
            enable_x64=_bool("REPRO_X64"),
            debug_nans=_bool("REPRO_DEBUG_NANS"),
            preallocate=_bool("REPRO_PREALLOCATE"),
            extra_xla_flags=tuple(e.get("REPRO_XLA_FLAGS", "").split()))

    @property
    def device(self) -> str:
        """The entry points' device for ``platform`` ("" when unset)."""
        if self.platform not in _PLATFORMS:
            raise ValueError(
                f"REPRO_PLATFORM={self.platform!r}: the port runs on "
                f"{sorted(p for p in _PLATFORMS if p)} only")
        return _PLATFORMS[self.platform]


def _alloc_conf(existing: str, expandable: bool) -> str:
    """``existing`` with its ``expandable_segments`` option set."""
    opts = [o for o in existing.split(",")
            if o and not o.startswith("expandable_segments:")]
    return ",".join(opts + [f"expandable_segments:{expandable}"])


def bootstrap(cfg: Optional[EnvConfig] = None, *,
              environ: Optional[MutableMapping[str, str]] = None,
              **kwargs) -> EnvConfig:
    """Apply cfg to the process (``environ`` given: to that mapping
    only).  Keyword form: ``bootstrap(platform="cpu")``.  Returns the
    applied config.  Call before the first CUDA initialization: the
    allocator reads its configuration once."""
    if cfg is None:
        cfg = EnvConfig(**kwargs)
    elif kwargs:
        raise TypeError("pass either a config or kwargs, not both")
    if cfg.host_device_count > 0:
        raise ValueError(
            f"REPRO_HOST_DEVICES={cfg.host_device_count}: torch does not "
            f"split one CPU into devices; run --cluster host:port,N,i with "
            f"N gloo ranks (REPRO_DIST_BACKEND=gloo) for N worker devices")
    cfg.device                                  # validates the platform
    e = os.environ if environ is None else environ
    if cfg.preallocate is not None:
        e["PYTORCH_CUDA_ALLOC_CONF"] = _alloc_conf(
            e.get("PYTORCH_CUDA_ALLOC_CONF", ""), not cfg.preallocate)
    if cfg.debug_nans is not None and environ is None:
        import torch
        torch.autograd.set_detect_anomaly(cfg.debug_nans)
    return cfg


def bootstrap_from_env(environ: Optional[MutableMapping[str, str]] = None
                       ) -> EnvConfig:
    """``bootstrap(EnvConfig.from_env())`` -- the entry-point one-liner."""
    return bootstrap(EnvConfig.from_env(environ), environ=environ)


# ------------------------------------------------------------- describe

def _nvidia_smi() -> Optional[str]:
    """The cards' ``name, power.limit`` as ``nvidia-smi`` prints them,
    or None where there is no ``nvidia-smi``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() if out.returncode == 0 else None


def describe() -> dict:
    """Snapshot the effective runtime environment (imports torch).

    Versions, device inventory, the card's name and power limit, this
    process's rank and world size, and the REPRO_* variables that
    produced them, in one JSON-serializable dict."""
    import platform as _platform

    import torch

    from repro_torch.runtime import cluster
    cuda = torch.cuda.is_available()
    info = cluster.active()
    return {
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "cuda_available": cuda,
        "device_count": torch.cuda.device_count() if cuda else 0,
        "devices": ([torch.cuda.get_device_name(i)
                     for i in range(torch.cuda.device_count())]
                    if cuda else []),
        "nvidia_smi": _nvidia_smi(),
        "process_index": info.process_index if info else 0,
        "process_count": info.process_count if info else 1,
        "backend": info.backend if info else "",
        "device": info.device if info else None,
        "debug_nans": torch.is_anomaly_enabled(),
        "alloc_conf": os.environ.get("PYTORCH_CUDA_ALLOC_CONF", ""),
        "env": {k: v for k, v in sorted(os.environ.items())
                if k.startswith(("REPRO_", "JAX_", "XLA_"))},
        "python": sys.version.split()[0],
        "hostname": _platform.node(),
        "pid": os.getpid(),
    }


def save_describe(path: str) -> dict:
    """Write the :func:`describe` snapshot to `path`; returns it."""
    snap = describe()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(snap, f, indent=1)
    return snap


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        description="bootstrap the env, then print/save describe()")
    ap.add_argument("--host-devices", type=int, default=0)
    ap.add_argument("--platform", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    bootstrap(host_device_count=args.host_devices, platform=args.platform)
    snap = save_describe(args.out) if args.out else describe()
    print(json.dumps(snap, indent=1))


if __name__ == "__main__":
    main()
