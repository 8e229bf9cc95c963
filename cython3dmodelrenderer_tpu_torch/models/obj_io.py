"""Wavefront OBJ / MTL / texture loading — host-side, NumPy only.

A copy of the JAX package's Python parser (``cython3dmodelrenderer_tpu/
models/obj_io.py``), which cannot be imported here because that package's
``__init__`` imports jax. Same rules as the reference loader
(``crender/py/data_structures/model.py:6-116,263-328``):

* lenient line-by-line parsing — malformed lines are skipped unless
  ``silent=False``, which raises on the first one;
* ``v`` takes the first three floats; ``vt`` takes all floats; ``vn``
  requires exactly three;
* faces are fan-triangulated (``[c0, c1+i, c2+i]``) and accept ``v``,
  ``v/vt``, ``v//vn`` and ``v/vt/vn`` corners;
* 1-based indices become 0-based; non-positive (end-relative) indices pass
  through unchanged;
* if any face corner lacks a ``vt`` (resp. ``vn``) index, the whole
  per-triangle texture-coordinate (resp. normal) table is dropped;
* ``mtllib`` resolves relative to the OBJ's directory, takes the last
  ``map_Kd`` entry and loads the texture in OpenCV's BGR order.

OpenCV is imported only to decode a texture file that exists; a missing
texture leaves the model untextured without touching ``cv2``. The native
C++ line parser of the JAX package has no counterpart yet.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class ObjData:
    """Raw parse result: vertex pools + per-triangle index tables."""

    vertices: np.ndarray                     # (V, 3) float32
    texture_coords: Optional[np.ndarray]     # (VT, >=2) float32 or None
    normals: Optional[np.ndarray]            # (VN, 3) float32 or None
    faces_v: np.ndarray                      # (T, 3) int32 — vertex indices
    faces_vt: Optional[np.ndarray]           # (T, 3) int32 or None
    faces_vn: Optional[np.ndarray]           # (T, 3) int32 or None
    texture: Optional[np.ndarray]            # (H, W, 3) uint8 BGR or None


def _read_vertex(data: str) -> List[float]:
    x, y, z = [float(tok) for tok in data.split()][:3]
    return [x, y, z]


def _read_texture_coord(data: str) -> List[float]:
    return [float(tok) for tok in data.split()]


def _read_normal(data: str) -> List[float]:
    nx, ny, nz = (float(tok) for tok in data.split())
    return [nx, ny, nz]


def _corner(token: str) -> Tuple[int, Optional[int], Optional[int]]:
    """One face corner ``v[/vt[/vn]]`` → (v, vt, vn) 0-based indices."""
    fields = token.split("/")[:3] + ["", ""]

    def to_index(field: str) -> Optional[int]:
        if not field:
            return None
        i = int(field)
        return i - 1 if i > 0 else i

    v = to_index(fields[0])
    if v is None:
        raise ValueError(f"face corner without a vertex index: {token!r}")
    return v, to_index(fields[1]), to_index(fields[2])


def _read_face(data: str):
    """Fan-triangulate one ``f`` record around its first corner."""
    corners = [_corner(tok) for tok in data.split()]
    out_v, out_vt, out_vn = [], [], []
    for b, c in zip(corners[1:-1], corners[2:]):
        tri = (corners[0], b, c)
        out_v.append([cn[0] for cn in tri])
        vt = [cn[1] for cn in tri]
        out_vt.append(None if None in vt else vt)
        vn = [cn[2] for cn in tri]
        out_vn.append(None if None in vn else vn)
    return out_v, out_vt, out_vn


def _obj_dir(filename: str) -> str:
    parts = filename.rsplit("/", 1)
    return parts[-2] + "/" if len(parts) == 2 else ""


def read_material_file(filename: str, origin: str) -> Optional[str]:
    """Parse an MTL file, returning the last ``map_Kd`` image path (or None)."""
    image_filename = None
    try:
        with open(filename.strip(), "r") as f:
            for line in f:
                if line == "" or line[0] == "#":
                    continue
                parts = line.split(" ", 1)
                if len(parts) != 2:
                    continue
                command, data = parts
                if command == "map_Kd":
                    image_filename = data
    except (OSError, UnicodeDecodeError) as e:  # lenient (model.py:107-112)
        print(f"warning: could not parse material file for '{origin}': {e}")
        print("warning: rendering untextured (material ignored)")
    return image_filename


def read_texture_file(filename: str) -> Optional[np.ndarray]:
    """Load a texture image in BGR order; None when the file is missing."""
    path = filename.strip()
    if not os.path.isfile(path):
        return None
    import cv2

    return cv2.imread(path)


def load_obj(filename: str, silent: bool = True,
             external_texture_filename: Optional[str] = None) -> ObjData:
    """Parse an OBJ file (plus its MTL/texture) into flat arrays."""
    vertices: List[List[float]] = []
    texture_coords: List[List[float]] = []
    normals: List[List[float]] = []
    faces_v: List[List[int]] = []
    faces_vt: Optional[List[List[int]]] = []
    faces_vn: Optional[List[List[int]]] = []

    texture = (read_texture_file(external_texture_filename)
               if external_texture_filename is not None else None)

    with open(filename.strip(), "r") as f:
        line_index = 0
        for line in f:
            try:
                if line == "" or line[0] == "#":
                    continue
                parts = line.split(" ", 1)
                if len(parts) != 2:
                    continue
                command, data = parts

                if command == "v":
                    vertices.append(_read_vertex(data))
                elif command == "vt":
                    texture_coords.append(_read_texture_coord(data))
                elif command == "vn":
                    normals.append(_read_normal(data))
                elif command == "f":
                    tv, tvt, tvn = _read_face(data)
                    faces_v.extend(tv)
                    if tvt.count(None) > 0:
                        faces_vt = None
                    if faces_vt is not None:
                        faces_vt.extend(tvt)
                    if tvn.count(None) > 0:
                        faces_vn = None
                    if faces_vn is not None:
                        faces_vn.extend(tvn)
                elif command == "mtllib" and texture is None:
                    mtl_path = (_obj_dir(filename) if data[0] != "/" else "") + data
                    image_filename = read_material_file(mtl_path, filename.strip())
                    if image_filename is not None:
                        image_filename = ((_obj_dir(filename)
                                           if image_filename[0] != "/" else "")
                                          + image_filename)
                        texture = read_texture_file(image_filename)
                line_index += 1
            except (ValueError, IndexError) as e:
                if not silent:
                    raise RuntimeError(
                        f'malformed OBJ line {line_index + 1} in '
                        f'"{filename}"') from e

    return _finalize(vertices, texture_coords, normals,
                     faces_v, faces_vt, faces_vn, texture)


def _finalize(vertices, texture_coords, normals,
              faces_v, faces_vt, faces_vn, texture) -> ObjData:
    arr_vertices = np.asarray(vertices, dtype=np.float32).reshape(-1, 3)
    arr_faces_v = np.asarray(faces_v, dtype=np.int32).reshape(-1, 3)
    arr_tc = (np.asarray(texture_coords, dtype=np.float32)
              if texture_coords else None)
    arr_n = (np.asarray(normals, dtype=np.float32).reshape(-1, 3)
             if normals else None)
    arr_fvt = (np.asarray(faces_vt, dtype=np.int32).reshape(-1, 3)
               if faces_vt else None)
    arr_fvn = (np.asarray(faces_vn, dtype=np.int32).reshape(-1, 3)
               if faces_vn else None)
    return ObjData(vertices=arr_vertices, texture_coords=arr_tc, normals=arr_n,
                   faces_v=arr_faces_v, faces_vt=arr_fvt, faces_vn=arr_fvn,
                   texture=texture)
