"""Build the CUDA sources of `csrc/` with nvcc at first use, into plain-C
shared libraries loaded with ctypes, and check the tensors a wrapper hands
them.

Each source builds into the package's own `build/` directory (listed in
.gitignore), under a name keyed by a hash of the source and the flags, so
an edited source rebuilds and an unchanged one loads at once. Nothing is
built when the package is imported: the CPU path needs no nvcc. A failed
build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "build"

#: Parity flags: no fused multiply-add, IEEE division and square root,
#: denormals kept (no --use_fast_math).
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-prec-div=true",
    "-prec-sqrt=true", "-ftz=false", "-Xptxas", "-v",
]

_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """nvcc of the CUDA toolkit PyTorch finds (CUDA_HOME, CUDA_PATH, PATH,
    then the toolkit's default prefix)."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.isfile(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels of blink_torch are built from source at first use"
    )


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def log_path(name: str) -> Path:
    """nvcc's output for the library of csrc/<name>.cu, with the -Xptxas -v
    register, shared-memory and spill summary."""
    return library_path(name).with_suffix(".log")


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    if name not in _LOADED:
        out = library_path(name)
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed for {name}.cu:\n{' '.join(cmd)}\n{proc.stdout}")
            log_path(name).write_text(proc.stdout)
            os.replace(tmp, out)
        _LOADED[name] = ctypes.CDLL(str(out))
    return _LOADED[name]


def check_arg(name: str, x, dtype, shape, device) -> None:
    """Raise unless tensor `x` has this dtype, shape and device and is
    contiguous: a kernel reads it through a raw pointer."""
    if x.device != device or x.dtype != dtype or tuple(x.shape) != shape:
        raise ValueError(
            f"{name}: want {dtype} {shape} on {device}, got {x.dtype} "
            f"{tuple(x.shape)} on {x.device}"
        )
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
