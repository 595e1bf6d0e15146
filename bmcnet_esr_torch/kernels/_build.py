"""Build a CUDA source under ``csrc/`` into a shared library and load it.

Each kernel source has a plain C interface and is compiled by ``nvcc`` for
``sm_90a`` (Hopper) into ``bmcnet_esr_torch/_build/<hash>/``, where the hash
covers the source text, the headers (``csrc/*.cuh``) and the compiler flags,
then loaded with ctypes.  The compiler's report (registers, shared memory
and spills of each kernel, ``-Xptxas -v``) is kept beside the library as
``<name>.log``.  A
build happens at the first launch in a process, never at import, so the
package imports on machines without a CUDA toolkit.  The library is written
under a temporary name and renamed into place, so concurrent first launches
from several processes are safe.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Sequence

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# what the launch plans assume of an H100 where the caller does not ask the
# card: its multiprocessors, and the dynamic shared memory one block may take
H100_SMS = 132
SMEM_LIMIT = 232_448

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
    sha = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src, *sorted(glob.glob(os.path.join(CSRC, "*.cuh")))]:
        with open(path, "rb") as f:
            sha.update(f.read())
    digest = sha.hexdigest()[:16]
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
        with open(os.path.splitext(lib)[0] + ".log", "w") as f:
            f.write(proc.stderr)
        os.replace(tmp, lib)
    return ctypes.CDLL(lib)


def device_kind(*ts: torch.Tensor) -> str:
    """``"cpu"`` or ``"cuda"``: the one device all of ``ts`` lie on."""
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"inputs on different devices: {sorted(map(str, devs))}")
    kind = ts[0].device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"kernels run on cpu or cuda tensors, not {kind}")
    return kind


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype, shape: Sequence[int]) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape``."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise TypeError(f"{name}: expected {dtype} {tuple(shape)}, got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch(fn, args: Sequence, device: torch.device, error_string: Callable) -> None:
    """Call the C entry point ``fn(*args, stream)`` on the current stream of
    ``device``; raise with CUDA's error text if the launch failed."""
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: {error_string(rc).decode()} ({rc})")
