"""Build the CUDA sources under ``kernels/csrc/`` and load them.

Each ``csrc/<name>.cu`` is a plain-C-interface shared library, compiled
by ``nvcc`` for ``sm_90a`` into ``<repo>/build/kernels/`` at first use
and loaded with ``ctypes``.  The library's file name carries a hash of
its source, the ``csrc/*.cuh`` headers it includes and the flags, so an
edited source or header is rebuilt and a built one is reused.  All
sources build at once, one ``nvcc`` process each, started together.  A failed build raises with the compiler's output: nothing
falls back to a plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")      # report registers/smem/spills

_LIBS: Dict[str, ctypes.CDLL] = {}       # process-wide loaded libraries
_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); the "
                           "kernels are built from source with nvcc")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def sources() -> Dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def _source_bytes(path: Path) -> bytes:
    """``path``'s bytes, then the name and bytes of each header beside it
    that it includes by ``#include "name"``."""
    data = path.read_bytes()
    return data + b"".join(b"\0" + inc + b"\0" +
                           (path.parent / inc.decode()).read_bytes()
                           for inc in _INCLUDE.findall(data))


def lib_path(name: str) -> Path:
    src = sources()[name]
    h = hashlib.sha256(_source_bytes(src) + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, str]:
    """Compile every source whose library is missing, all in parallel.

    Returns {name: compiler output} for the sources compiled by this call
    (with ptxas's registers, shared memory and spills per kernel).
    Raises if any compile fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in sources():
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(sources()[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)        # atomic: a reader never sees half
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib: Optional[ctypes.CDLL] = _LIBS.get(name)
    if lib is None:
        if name not in sources():
            raise KeyError(f"no CUDA source csrc/{name}.cu")
        path = lib_path(name)
        if not path.exists():
            build_all()
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib
