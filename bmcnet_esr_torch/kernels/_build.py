"""Build a CUDA source under ``csrc/`` into a shared library and load it.

Each kernel source has a plain C interface and is compiled by ``nvcc`` for
``sm_90a`` (Hopper) into ``bmcnet_esr_torch/_build/<hash>/``, where the hash
covers the source text and the compiler flags, then loaded with ctypes.  A
build happens at the first launch in a process, never at import, so the
package imports on machines without a CUDA toolkit.  The library is written
under a temporary name and renamed into place, so concurrent first launches
from several processes are safe.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def find_nvcc() -> str:
    """``nvcc`` from ``PATH``, else from the toolkit PyTorch itself found."""
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.isfile(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: a CUDA toolkit is needed to build the kernels")


def load_library(source: str) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` (once per content hash) and ``dlopen`` it."""
    with _LOCK:
        lib = _LOADED.get(source)
    if lib is None:
        lib = _build_and_load(source)
        with _LOCK:
            lib = _LOADED.setdefault(source, lib)
    return lib


def build_all(sources: Sequence[str]) -> None:
    """Build several sources at once, one ``nvcc`` process each."""
    with ThreadPoolExecutor(max_workers=max(len(sources), 1)) as pool:
        list(pool.map(load_library, sources))


def _build_and_load(source: str) -> ctypes.CDLL:
    src = os.path.join(CSRC, source)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = os.path.join(BUILD_DIR, digest)
    lib = os.path.join(out_dir, os.path.splitext(source)[0] + ".so")
    if not os.path.isfile(lib):
        os.makedirs(out_dir, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) for {source}:\n{proc.stderr}"
            )
        os.replace(tmp, lib)
    return ctypes.CDLL(lib)
