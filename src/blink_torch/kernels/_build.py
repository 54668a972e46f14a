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
import re
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


def library_path(name: str, defines: tuple[str, ...] = ()) -> Path:
    """The library of csrc/<name>.cu built with `defines` (nvcc -D flags,
    such as a counting build's), keyed by the source, the flags and the
    defines."""
    src = CSRC / f"{name}.cu"
    flags = " ".join([*NVCC_FLAGS, *(f"-D{x}" for x in defines)])
    h = hashlib.sha256(src.read_bytes() + flags.encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def log_path(name: str, defines: tuple[str, ...] = ()) -> Path:
    """nvcc's output for the library of csrc/<name>.cu, with the -Xptxas -v
    register, shared-memory and spill summary."""
    return library_path(name, defines).with_suffix(".log")


def ptxas_spills(text: str) -> dict[str, int]:
    """The bytes each kernel spills (stores plus loads), from ptxas's -v
    report in nvcc's output `text`, by the kernel's mangled name. Device
    functions that ptxas reports on their own are left out."""
    entries, spills, name = set(), {}, None
    for line in text.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            entries.add(m.group(1))
        elif m := re.search(r"Function properties for (\w+)", line):
            name = m.group(1)
        elif (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)) and name:
            spills[name] = int(m.group(1)) + int(m.group(2))
            name = None
    return {k: v for k, v in spills.items() if k in entries}


def load(name: str, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu built with `defines`, built
    first if needed."""
    key = " ".join((name, *defines))
    if key not in _LOADED:
        out = library_path(name, defines)
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, *(f"-D{x}" for x in defines), "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed for {name}.cu:\n{' '.join(cmd)}\n{proc.stdout}")
            log_path(name, defines).write_text(proc.stdout)
            os.replace(tmp, out)
        _LOADED[key] = ctypes.CDLL(str(out))
    return _LOADED[key]


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
