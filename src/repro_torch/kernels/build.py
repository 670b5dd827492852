"""Build the port's CUDA sources into shared libraries, at first use.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by hand
with ``nvcc`` for Hopper (``sm_90a``) into ``build/repro_torch/`` at the
repository root, then loaded with :mod:`ctypes`. A library is named after
a hash of its source and flags, so an edited source builds anew and an
unchanged one loads from the previous build. A failed build raises.

Every wrapper binds its C launcher through :func:`launcher` and passes the
stream from :data:`raw_stream`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: library path -> loaded library
_LIBS: dict[str, ctypes.PyDLL] = {}
# one lock per source, so that different sources build concurrently
_LOCKS: dict[str, threading.Lock] = {}
_LOCKS_LOCK = threading.Lock()
#: per source name: (seconds the build took, or 0.0 when loaded from a
#: previous build; the compiler's output)
BUILD_INFO: dict[str, tuple[float, str]] = {}

#: device index -> that device's current CUDA stream as an integer handle,
#: in one call. None in a CPU-only PyTorch, where no wrapper reaches it.
raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def library_path(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def load(name: str) -> ctypes.PyDLL:
    """The compiled library of ``csrc/<name>.cu`` (from :data:`CSRC` as it
    stands), built if needed. Calls for different sources may run in
    parallel threads."""
    with _LOCKS_LOCK:
        lock = _LOCKS.setdefault(name, threading.Lock())
    with lock:
        path = library_path(name)
        lib = _LIBS.get(str(path))
        if lib is not None:
            return lib
        if path.exists():
            BUILD_INFO[name] = (0.0, "")
        else:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            secs = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}.cu "
                                   f"(exit {proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, path)      # atomic: concurrent builds agree
            BUILD_INFO[name] = (secs, proc.stdout + proc.stderr)
        # a launcher only queues a kernel, so keeping the GIL across the
        # call costs less than releasing and retaking it
        lib = ctypes.PyDLL(str(path))
        _LIBS[str(path)] = lib
        return lib


def launcher(name: str, symbol: str, argtypes: list):
    """The C launcher ``symbol`` of ``csrc/<name>.cu`` (built if needed),
    taking ``argtypes`` and returning an ``int`` CUDA error code. Wrappers
    resolve it once (``functools.cache``)."""
    fn = getattr(load(name), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn
