"""Build the port's CUDA kernels from ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc``
alone (no PyTorch headers, so a build takes seconds) into
``build/kernels/lib<name>-<hash>.so`` next to the package, at first use.
The hash covers the source and the flags, so an edited source never loads a
stale library. Target ``sm_90a`` (Hopper). Float contract: no fast math, and
``-fmad=false`` so nvcc never fuses a multiply and an add into an FMA —
the raster arithmetic must round like the plain PyTorch version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return path


def library_path(name: str) -> Path:
    source = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def compile_source(source: Path, out: Path) -> str:
    """nvcc ``source`` into the library ``out`` with ``NVCC_FLAGS``; return
    the compiler's report (``-Xptxas=-v``: registers, shared memory,
    spills), which is also kept beside the library as ``.log``."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    res = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{res.stderr}")
    out.with_suffix(".log").write_text(res.stdout + res.stderr)
    os.replace(tmp, out)
    return res.stdout + res.stderr


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library exists; return its path."""
    out = library_path(name)
    if not out.exists():
        compile_source(CSRC / f"{name}.cu", out)
    return out


def open_library(path: Path) -> ctypes.CDLL:
    """Load a built library with its ``kernel_error_string``."""
    lib = ctypes.CDLL(str(path))
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = open_library(build(name))
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a launcher returned a CUDA error code."""
    if err != 0:
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"{what} failed to launch: CUDA error {err} ({msg})")


def stream_handle(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as an integer handle."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
