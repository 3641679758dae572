"""Build the package's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface.  ``load(name)`` compiles
it with nvcc for Hopper (sm_90a) into ``csrc/build/`` (ignored by git),
under a file name that carries the hash of the source and of the headers
beside it (``*.cuh``), so an edited source or header is rebuilt, and
returns the ``ctypes.CDLL``.  Building needs nvcc (found on PATH, under
$CUDA_HOME, or at /usr/local/cuda) and happens only when a kernel is first
launched, never at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

from ..utils.logging import log

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: a CUDA toolkit is needed to build "
                       "the package's kernels")


def lib_path(name: str) -> str:
    """Where csrc/<name>.cu builds to: the name carries a hash of the
    source, of every header in csrc/ (sources include them) and of the
    flags."""
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for f in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC, f), "rb") as fh:
            digest.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def load(name: str) -> ctypes.CDLL:
    """The compiled library of csrc/<name>.cu, building it if needed."""
    if name in _LIBS:
        return _LIBS[name]
    out = lib_path(name)
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, f"{name}.cu")]
        t0 = time.time()
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{r.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
        log(f"built {os.path.basename(out)} in {time.time() - t0:.1f}s")
    _LIBS[name] = ctypes.CDLL(out)
    return _LIBS[name]
