"""Build and load the package's CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles every source into one shared library with a plain C
interface, which ``ctypes`` loads. No PyTorch header is included, so the
build takes seconds rather than the minutes a ``torch/extension.h`` build
takes, and it needs neither ninja nor ``torch.utils.cpp_extension``. The
JAX package builds its host C++ the same way (g++ plus ctypes).

The library is written to ``food101_sr_tpu_torch/_build/`` under a name
that carries a hash of the sources and flags, so an edited source rebuilds
and a stale library is never loaded. Nothing is built when the package is
imported: :func:`kernels` builds on first use, which only a CUDA tensor
reaches.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_entries: dict = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc`` (default ``/usr/local/cuda``), else PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the CUDA "
            "kernels of food101_sr_tpu_torch cannot be built")
    return found


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_DIR, "csrc", "*.cu")))


def _library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libkernels-{h.hexdigest()[:16]}.so")


def _compile(so: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, *_sources()]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing


def _register(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.f101_blur5_f32.argtypes = [p, p, ll, i, i, p, i, p]
    lib.f101_blur5_f32.restype = i
    for name in ("f101_plane_mean_f32", "f101_plane_mean_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, ll, ll, i, p]
        fn.restype = i
    for name in ("f101_nhwc_mean_f32", "f101_nhwc_mean_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, ll, ll, ll, i, p]
        fn.restype = i


def kernels() -> ctypes.CDLL:
    """The loaded kernel library, built first if its sources changed."""
    global _lib
    with _lock:
        if _lib is None:
            so = _library_path()
            if not os.path.exists(so):
                _compile(so)
            lib = ctypes.CDLL(so)
            _register(lib)
            _lib = lib
        return _lib


def entry(name: str):
    """The bound C entry point ``name``, looked up once (the kernel
    wrappers call this on every launch)."""
    fn = _entries.get(name)
    if fn is None:
        fn = _entries[name] = getattr(kernels(), name)
    return fn


def current_stream(device_index: int) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on the device,
    without building a ``torch.cuda.Stream`` object per call (CUDA builds
    of torch only; the wrappers call it for CUDA tensors only)."""
    return torch._C._cuda_getCurrentRawStream(device_index)


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
