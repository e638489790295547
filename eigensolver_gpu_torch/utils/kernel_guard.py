"""Kernel loader: build the CUDA sources under ``csrc/`` and bind them.

Counterpart of eigensolver_gpu_tpu/utils/kernel_guard.py, with the
opposite policy. The JAX guard probes each Mosaic kernel and falls back
to the XLA path when the toolchain rejects it. Here there is no probe
and no fallback: a wrapper given a CUDA tensor launches its kernel, and
if the kernel cannot be built, loaded or launched the call raises.
Only a tensor on the CPU takes the plain PyTorch version, and it does so
in the wrapper, on the tensor's device alone.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first
use with

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

into ``eigensolver_gpu_torch/build/`` (git-ignored), under a file name
that carries a hash of the source, so an edited source is rebuilt and a
stale library is never loaded. Each source has its own lock, so
:func:`load` called from several threads runs one ``nvcc`` per source at
once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_libs: dict[str, ctypes.CDLL] = {}
_locks: dict[str, threading.Lock] = {}
_locks_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> pathlib.Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD / f"lib{name}-{digest}.so"


def _build(name: str) -> None:
    """Compile csrc/<name>.cu unless its library is current."""
    out = _target(name)
    if out.exists():
        return
    nvcc = _nvcc()
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{proc.stdout}")
    os.replace(tmp, out)


def load(name: str) -> ctypes.CDLL:
    """The shared library of csrc/<name>.cu, built on first use."""
    with _locks_lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        lib = _libs.get(name)
        if lib is None:
            _build(name)
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
        return lib


def check(status: int, what: str) -> None:
    """Raise when a launch function returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")
