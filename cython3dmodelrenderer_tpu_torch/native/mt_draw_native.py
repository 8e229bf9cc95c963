"""ctypes bindings for the exact generator draw (``mt_draw.cpp``).

``draw_u8(generator, out)`` fills a uint8 CPU tensor with what
``torch.randint(256, out.shape, generator=generator)`` would give, and
leaves the generator's state where that call would, bit for bit: the C
function advances torch's Mersenne Twister on the bytes of
``generator.get_state()``, which ``set_state`` then loads back. It skips
the int64 tensor and the per-element dispatch of ``torch.randint``.

The library builds at first use with ``g++`` (``native.build_library``)
into ``build/native/libmtdraw-<hash>.so``. Where no ``g++`` is installed,
or the generator's state is not the layout the C function knows (another
size, or fields an engine would refuse), ``draw_u8`` returns False, draws
nothing and leaves the generator as it was; the caller then draws with
``torch.randint``.
"""
from __future__ import annotations

import ctypes
import shutil
import threading
from pathlib import Path
from typing import Optional

import torch

from .. import native

SOURCE = Path(__file__).resolve().parent / "mt_draw.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _load() -> Optional[ctypes.CDLL]:
    """The bound library, built on first use; None without ``g++``."""
    global _lib
    with _lock:
        if _lib is None:
            cxx = shutil.which("g++")
            if cxx is None:
                return None
            lib = ctypes.CDLL(str(native.build_library(
                cxx, SOURCE, BUILD_DIR, "mtdraw", CXX_FLAGS)))
            lib.mt_state_bytes.restype = ctypes.c_int64
            lib.mt_state_bytes.argtypes = []
            lib.mt_draw_u8.restype = ctypes.c_int
            lib.mt_draw_u8.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                       ctypes.c_void_p, ctypes.c_int64]
            lib.state_bytes = lib.mt_state_bytes()
            _lib = lib
        return _lib


def draw_u8(generator: torch.Generator, out: torch.Tensor) -> bool:
    """Draw ``torch.randint(256, out.shape, generator=generator)`` into the
    contiguous uint8 CPU tensor ``out`` and advance ``generator`` as that
    call would; False (nothing drawn, ``generator`` untouched) without
    ``g++`` or where its state is not the layout ``mt_draw.cpp`` reads."""
    if (out.dtype != torch.uint8 or out.device.type != "cpu"
            or not out.is_contiguous()):
        raise ValueError("draw_u8 writes a contiguous uint8 CPU tensor")
    lib = _lib if _lib is not None else _load()
    if lib is None:
        return False
    state = generator.get_state()
    if state.numel() != lib.state_bytes:
        return False
    if lib.mt_draw_u8(state.data_ptr(), state.numel(), out.data_ptr(),
                      out.numel()) != 0:
        return False
    generator.set_state(state)
    return True
