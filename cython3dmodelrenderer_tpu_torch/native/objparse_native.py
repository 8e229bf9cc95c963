"""ctypes bindings for the native OBJ parser (``objparse.cpp``).

Counterpart of ``cython3dmodelrenderer_tpu/native/objparse_native.py``.
The library builds at first use with ``g++ -O2 -shared -fPIC -std=c++17``
(a plain C ABI, no pybind11) into ``build/native/libobjparse-<hash>.so``
beside the package, as the package's ``build_library`` builds every
native source.

Where no ``g++`` is installed, ``available()`` is False and
``models/obj_io.py`` parses in Python (the JAX package's contract for this
host parser; the result is the same). A compiler that fails raises.
"""
from __future__ import annotations

import ctypes
import shutil
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from .. import native

SOURCE = Path(__file__).resolve().parent / "objparse.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    return native.library_path(SOURCE, BUILD_DIR, "objparse", CXX_FLAGS)


def build(cxx: str) -> Path:
    """Compile ``objparse.cpp`` with ``cxx`` unless its library exists;
    return the library's path."""
    return native.build_library(cxx, SOURCE, BUILD_DIR, "objparse",
                                CXX_FLAGS)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.obj_parse.restype = ctypes.c_void_p
    lib.obj_parse.argtypes = [ctypes.c_char_p]
    lib.obj_free.restype = None
    lib.obj_free.argtypes = [ctypes.c_void_p]
    for name in ("obj_num_vertices", "obj_num_texcoords", "obj_num_normals",
                 "obj_num_triangles"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p]
    for name in ("obj_have_vt", "obj_have_vn", "obj_max_tc_dim"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int32
        fn.argtypes = [ctypes.c_void_p]
    for name, ty in (("obj_vertices", ctypes.c_float),
                     ("obj_texcoords", ctypes.c_float),
                     ("obj_normals", ctypes.c_float),
                     ("obj_faces_v", ctypes.c_int32),
                     ("obj_faces_vt", ctypes.c_int32),
                     ("obj_faces_vn", ctypes.c_int32),
                     ("obj_texcoord_dims", ctypes.c_int32)):
        fn = getattr(lib, name)
        fn.restype = ctypes.POINTER(ty)
        fn.argtypes = [ctypes.c_void_p]
    lib.obj_mtllibs.restype = ctypes.c_char_p
    lib.obj_mtllibs.argtypes = [ctypes.c_void_p]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The bound library, built on first use; None without ``g++``."""
    global _lib
    with _lock:
        if _lib is None:
            cxx = shutil.which("g++")
            if cxx is None:
                return None
            _lib = _bind(ctypes.CDLL(str(build(cxx))))
        return _lib


def available() -> bool:
    return _load() is not None


def _as_array(ptr, count: int, dtype) -> np.ndarray:
    if count == 0:
        return np.empty((0,), dtype=dtype)
    return np.ctypeslib.as_array(ptr, shape=(count,)).astype(dtype, copy=True)


def parse(filename: str):
    """Parse an OBJ file natively.

    Returns (vertices (V, 3) f32, texture_coords (VT, d) f32 or None,
    normals (VN, 3) f32 or None, faces_v (T, 3) i32, faces_vt (T, 3) i32
    or None, faces_vn (T, 3) i32 or None, mtllib names), or None without
    ``g++``; raises ``FileNotFoundError`` when the file cannot be opened.
    """
    lib = _load()
    if lib is None:
        return None
    ctx = lib.obj_parse(filename.encode())
    if not ctx:
        raise FileNotFoundError(filename)
    try:
        nv = lib.obj_num_vertices(ctx)
        nt = lib.obj_num_triangles(ctx)
        ntc = lib.obj_num_texcoords(ctx)
        nn = lib.obj_num_normals(ctx)
        vertices = _as_array(lib.obj_vertices(ctx), nv * 3,
                             np.float32).reshape(-1, 3)
        faces_v = _as_array(lib.obj_faces_v(ctx), nt * 3,
                            np.int32).reshape(-1, 3)
        texture_coords = None
        if ntc:
            tc3 = _as_array(lib.obj_texcoords(ctx), ntc * 3,
                            np.float32).reshape(-1, 3)
            texture_coords = tc3[:, :max(int(lib.obj_max_tc_dim(ctx)), 1)]
        normals = (_as_array(lib.obj_normals(ctx), nn * 3,
                             np.float32).reshape(-1, 3) if nn else None)
        faces_vt = (_as_array(lib.obj_faces_vt(ctx), nt * 3,
                              np.int32).reshape(-1, 3)
                    if lib.obj_have_vt(ctx) and ntc else None)
        faces_vn = (_as_array(lib.obj_faces_vn(ctx), nt * 3,
                              np.int32).reshape(-1, 3)
                    if lib.obj_have_vn(ctx) and nn else None)
        raw = lib.obj_mtllibs(ctx).decode(errors="replace")
        mtllibs = [m for m in raw.split("\n") if m]
        return (vertices, texture_coords, normals, faces_v, faces_vt,
                faces_vn, mtllibs)
    finally:
        lib.obj_free(ctx)
