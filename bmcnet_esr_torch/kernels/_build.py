"""Build a source under ``csrc/`` into a shared library and load it.

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

:func:`define_op` registers each kernel as a ``torch.library`` operator in
the ``bmcnet`` namespace; the checks below serve the public wrappers and the
operators' CUDA registrations alike.
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

HOST_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()

# the kernels' operators, ``torch.ops.bmcnet.*``, registered when each
# kernel module is imported
OPS = torch.library.Library("bmcnet", "FRAGMENT")


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


def load_host_library(source: str) -> ctypes.CDLL:
    """Compile the host C++ source ``csrc/<source>`` with ``c++`` (once per
    hash of the source and ``HOST_FLAGS``) and ``dlopen`` it."""
    with _LOCK:
        lib = _LOADED.get(source)
    if lib is None:
        src = os.path.join(CSRC, source)
        compiler = shutil.which("c++") or shutil.which("g++")
        if compiler is None:
            raise RuntimeError(f"no C++ compiler (c++ or g++) on PATH to build {source}")
        lib = ctypes.CDLL(_compile([compiler, *HOST_FLAGS], src, [src]))
        with _LOCK:
            lib = _LOADED.setdefault(source, lib)
    return lib


def build_all(sources: Sequence[str]) -> None:
    """Build several sources at once, one ``nvcc`` process each."""
    with ThreadPoolExecutor(max_workers=max(len(sources), 1)) as pool:
        list(pool.map(load_library, sources))


def _build_and_load(source: str) -> ctypes.CDLL:
    src = os.path.join(CSRC, source)
    headers = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    return ctypes.CDLL(_compile([find_nvcc(), *NVCC_FLAGS], src, [src, *headers]))


def _compile(compiler_and_flags: Sequence[str], src: str, hashed: Sequence[str]) -> str:
    """Build ``src`` into ``_build/<hash>/<name>.so`` unless it is there;
    the hash covers the command's flags and the files ``hashed``.  The
    compiler writes a temporary file that is renamed into place, so a
    concurrent build or load never sees half a library.  Returns the path."""
    sha = hashlib.sha256(" ".join(compiler_and_flags[1:]).encode())
    for path in hashed:
        with open(path, "rb") as f:
            sha.update(f.read())
    out_dir = os.path.join(BUILD_DIR, sha.hexdigest()[:16])
    name = os.path.splitext(os.path.basename(src))[0]
    lib = os.path.join(out_dir, name + ".so")
    if not os.path.isfile(lib):
        os.makedirs(out_dir, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.{threading.get_ident()}.tmp"
        proc = subprocess.run([*compiler_and_flags, "-o", tmp, src],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{os.path.basename(compiler_and_flags[0])} failed "
                               f"({proc.returncode}) for {os.path.basename(src)}:\n{proc.stderr}")
        with open(os.path.join(out_dir, name + ".log"), "w") as f:
            f.write(proc.stderr)
        os.replace(tmp, lib)
    return lib


def device_kind(*ts: torch.Tensor) -> str:
    """``"cpu"`` or ``"cuda"``: the one device all of ``ts`` lie on."""
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"inputs on different devices: {sorted(map(str, devs))}")
    kind = ts[0].device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"kernels run on cpu or cuda tensors, not {kind}")
    return kind


def refuse_strided(x: torch.Tensor) -> None:
    """The wrappers' check of an activation: a CUDA tensor must be
    contiguous (its NHWC memory is what the kernel reads; a caller's NCHW
    memory seen as NHWC is refused, never reinterpreted)."""
    if x.is_cuda and not x.is_contiguous():
        raise ValueError("x must be contiguous NHWC")


def dense(x: torch.Tensor) -> torch.Tensor:
    """What the CUDA registrations give their kernels: ``x`` when contiguous,
    else a contiguous copy.  A program traced by ``torch.export`` decides at
    trace time, from fake tensors, where it copies into NHWC memory, and on
    CUDA a fake tensor's memory format can differ from the real one's, so
    the operator copies what such a program hands it rather than refuse it
    (the wrappers refuse it from eager callers: :func:`refuse_strided`)."""
    return x.contiguous()


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype, shape: Sequence[int]) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape``."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise TypeError(f"{name}: expected {dtype} {tuple(shape)}, got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def define_op(schema: str, cpu: Callable, cuda: Callable, fake: Callable):
    """Define the operator ``bmcnet::<schema>`` with three registrations:
    ``cpu`` (the plain version) for the CPU key, ``cuda`` (the launch) for
    the CUDA key, and ``fake``, which gives the output's shape, dtype and
    strides from the inputs' alone, for tracing (``torch.export``, fake
    tensors).  ``torch.library.Library`` rather than ``custom_op``: its
    dispatch costs the host less per call, and the int8 paths make a
    hundred and more calls a forward (``PERF.md``).  Returns the overload."""
    name = schema.split("(", 1)[0]
    OPS.define(schema)
    OPS.impl(name, cpu, "CPU")
    OPS.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"bmcnet::{name}", fake, lib=OPS)
    op, _, overload = name.partition(".")
    return getattr(getattr(torch.ops.bmcnet, op), overload or "default")


def launch(fn, args: Sequence, device: torch.device, error_string: Callable) -> None:
    """Call the C entry point ``fn(*args, stream)`` on the current stream of
    ``device``; raise with CUDA's error text if the launch failed."""
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: {error_string(rc).decode()} ({rc})")
