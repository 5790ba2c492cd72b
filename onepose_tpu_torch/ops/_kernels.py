"""Build and load the port's CUDA kernels.

Every ``onepose_tpu_torch/csrc/*.cu`` file is compiled by ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, loaded with
``ctypes``. The build runs at first use, into ``build/onepose_tpu_torch/``
at the repository root, under a name keyed on a hash of the sources and
flags, so an edited source rebuilds and an unchanged one loads at once.
A failed build raises. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "onepose_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: argument types; each returns a cudaError_t as int.
_SIGNATURES = {
    "stem_forward": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "match_stats": [_P, _P, _I, _I, _I, _I, _F, _P, _P, _P, _P, _P],
    "match_argmax": [_P, _P, _I, _I, _I, _I, _F, _P, _P, _P, _P,
                     _P, _P, _P, _P, _P],
}

_lib = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return str(nvcc)


def library_path() -> Path:
    """Path of the shared library for the current sources."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libonepose_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels if the current sources have no library yet.
    nvcc's messages (ptxas register and shared-memory use) go to
    ``<library>.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    sources = [str(s) for s in sorted(CSRC.glob("*.cu"))]
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *sources]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = out.with_name(out.name + ".log")
    log.write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.onepose_cuda_error_string.argtypes = [ctypes.c_int]
        lib.onepose_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def launch(name: str, *args) -> None:
    """Call C entry point ``name`` on PyTorch's current CUDA stream; raise
    if the launch was refused."""
    lib = library()
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib, name)(*args, stream)
    if err != 0:
        msg = lib.onepose_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def check_aligned(name: str, t: torch.Tensor, nbytes: int = 16) -> None:
    """Raise unless ``t``'s data starts on an ``nbytes`` boundary (the
    kernels load some operands as float4)."""
    if t.data_ptr() % nbytes:
        raise ValueError(f"{name}: data must be {nbytes}-byte aligned")


def check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype,
               shape: tuple) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``dtype`` and ``shape``
    on the current CUDA device."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.device.index != torch.cuda.current_device():
        # kernels launch on the current device's current stream
        raise ValueError(f"{name}: tensor on {t.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
