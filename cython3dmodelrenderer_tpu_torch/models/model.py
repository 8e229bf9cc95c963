"""Scene model: device-resident geometry + transforms.

Counterpart of ``cython3dmodelrenderer_tpu/models/model.py``, with the
reference ``Model`` API (``crender/py/data_structures/model.py:118-328``):
``read_model``, ``shift/scale/rotate``, ``get_triangle/get_vertex``,
``get_mean_vertex/get_max_span``, ``n_triangles/n_vertices``. Geometry lives
as torch tensors on the model's ``device``; per-vertex colors are
pre-sampled from the texture at load time (nearest neighbour, V flip,
clip — ``model.py:147-150``) and stored as float32.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops import transforms as T
from ..utils import timing
from . import obj_io


def _index_table(faces, pool_size: int) -> np.ndarray:
    """(T, 3) int32 table with end-relative (negative) indices resolved."""
    f = np.asarray(faces, dtype=np.int32).reshape(-1, 3)
    return np.where(f < 0, f + pool_size, f).astype(np.int32)


class Model:
    @staticmethod
    def read_model(filename: str, silent: bool = True,
                   external_texture_filename: Optional[str] = None,
                   recalculate_normals: bool = True,
                   invert_calculated_normals: bool = False,
                   device=None) -> "Model":
        data = obj_io.load_obj(filename, silent=silent,
                               external_texture_filename=external_texture_filename)
        return Model(data.vertices, data.faces_v,
                     texture_coords=data.texture_coords,
                     triangles_texture_coords=data.faces_vt,
                     texture=data.texture,
                     normals=data.normals,
                     triangles_normals=data.faces_vn,
                     recalculate_normals=recalculate_normals,
                     invert_calculated_normals=invert_calculated_normals,
                     device=device)

    @classmethod
    def from_state(cls, state: Dict[str, np.ndarray], device=None) -> "Model":
        """A model that holds exactly the given arrays, recomputing nothing.

        ``state`` has ``vertices`` (V, 3), ``faces_v`` (T, 3), ``normals``
        (N, 3), ``faces_n`` (T, 3) and optionally ``colors`` (C, 3) with
        ``faces_vt`` (T, 3) and ``texture``. Indices must be resolved
        (non-negative). Only the mean/span statistics and the incidence
        table (topology) are derived. Adds the host seconds taken to
        ``model_state_s`` in ``utils.timing.counters``.
        """
        started = time.perf_counter()
        self = cls.__new__(cls)
        self._device = resolve_device(device)
        vertices = np.asarray(state["vertices"], np.float32).reshape(-1, 3)
        faces_v = _index_table(state["faces_v"], len(vertices))
        self._init_geometry(vertices, faces_v, invert_calculated_normals=False)
        self._normals = self._tensor(np.asarray(state["normals"], np.float32))
        self._faces_n = self._tensor(_index_table(state["faces_n"],
                                                  len(state["normals"])))
        self._file_normals = self._file_faces_vn = None
        self._refresh_stats()
        colors = state.get("colors")
        self._texture = self._texture_coords = None
        if colors is None:
            self._colors = self._faces_vt = None
        else:
            self._colors = self._tensor(np.asarray(colors, np.float32))
            self._faces_vt = self._tensor(_index_table(state["faces_vt"],
                                                       len(colors)))
            if state.get("texture") is not None:
                self._texture = self._tensor(np.asarray(state["texture"]))
        timing.counters["model_state_s"] += time.perf_counter() - started
        return self

    def __init__(self, vertices, triangles_vertices,
                 texture_coords=None, triangles_texture_coords=None,
                 texture=None, normals=None, triangles_normals=None,
                 recalculate_normals: bool = True,
                 invert_calculated_normals: bool = False,
                 device=None):
        self._device = resolve_device(device)
        vertices = np.asarray(vertices, dtype=np.float32).reshape(-1, 3)
        faces_v = _index_table(triangles_vertices, len(vertices))
        self._init_geometry(vertices, faces_v, invert_calculated_normals)

        if normals is not None and triangles_normals is not None:
            file_normals = np.asarray(normals, dtype=np.float32).reshape(-1, 3)
            self._file_normals = self._tensor(file_normals)
            self._file_faces_vn = self._tensor(
                _index_table(triangles_normals, len(file_normals)))
        else:
            self._file_normals = None
            self._file_faces_vn = None

        if not recalculate_normals and self._file_normals is not None:
            self._normals, self._faces_n = self._file_normals, self._file_faces_vn
        else:
            self._recompute_normals()
        self._refresh_stats()

        # texture → per-vertex colors (reference model.py:135-150)
        if texture_coords is None or triangles_texture_coords is None or texture is None:
            self._texture_coords = None
            self._faces_vt = None
            self._texture = None
            self._colors = None
        else:
            tc = np.asarray(texture_coords, dtype=np.float32)
            tex = np.asarray(texture)
            h, w = tex.shape[0], tex.shape[1]
            rows = np.clip(((1.0 - tc[:, 1]) * h).astype("int32"), 0, h - 1)
            cols = np.clip((tc[:, 0] * w).astype("int32"), 0, w - 1)
            self._texture_coords = self._tensor(tc)
            self._faces_vt = self._tensor(_index_table(triangles_texture_coords,
                                                       len(tc)))
            self._texture = self._tensor(tex)
            self._colors = self._tensor(tex[rows, cols].astype(np.float32))

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------

    def _tensor(self, array: np.ndarray) -> torch.Tensor:
        return torch.tensor(array, device=self._device)   # owns a copy

    def _init_geometry(self, vertices: np.ndarray, faces_v: np.ndarray,
                       invert_calculated_normals: bool) -> None:
        self._vertices = self._tensor(vertices)
        self._faces_v = self._tensor(faces_v)
        inc, inc_valid = T.build_incidence(faces_v, len(vertices))
        self._incidence = self._tensor(inc)
        self._incidence_valid = self._tensor(inc_valid)
        self._invert_calculated_normals = invert_calculated_normals
        self._invalidate_caches()

    def _invalidate_caches(self) -> None:
        self._vbt_cache = None
        self._nbt_cache = None

    def _recompute_normals(self) -> None:
        n = T.vertex_normals(self._vertices, self._faces_v,
                             self._incidence, self._incidence_valid)
        self._normals = -n if self._invert_calculated_normals else n
        self._faces_n = self._faces_v

    def _refresh_stats(self) -> None:
        self._mean_vertex, self._max_span = T.mean_and_span(self._vertices)

    def _update_vertices(self, new_vertices: torch.Tensor,
                         recalculate_normals: bool) -> None:
        self._vertices = new_vertices
        self._invalidate_caches()
        if recalculate_normals:
            self._recompute_normals()
        self._refresh_stats()

    # ------------------------------------------------------------------
    # transforms (reference model.py:212-255)
    # ------------------------------------------------------------------

    def shift(self, shift) -> None:
        self._update_vertices(T.shift(self._vertices, shift),
                              recalculate_normals=False)

    def scale(self, scale_coef, keep_position: bool = True) -> None:
        self._update_vertices(
            T.scale(self._vertices, scale_coef, mean_vertex=self._mean_vertex,
                    keep_position=keep_position),
            recalculate_normals=False)

    def rotate(self, angles) -> None:
        if len(angles) != 3:
            raise ValueError("rotate takes three Euler angles")
        self._update_vertices(T.rotate(self._vertices, angles),
                              recalculate_normals=True)

    # ------------------------------------------------------------------
    # batched accessors (cached; invalidated by transforms)
    # ------------------------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def vertices(self) -> torch.Tensor:
        return self._vertices

    @property
    def normals(self) -> torch.Tensor:
        return self._normals

    @property
    def vertices_by_triangles(self) -> torch.Tensor:
        if self._vbt_cache is None:
            self._vbt_cache = self._vertices[self._faces_v.long()]
        return self._vbt_cache

    @property
    def normals_by_triangles(self) -> torch.Tensor:
        if self._nbt_cache is None:
            self._nbt_cache = self._normals[self._faces_n.long()]
        return self._nbt_cache

    @property
    def colors_by_triangles(self) -> Optional[torch.Tensor]:
        if self._colors is None:
            return None
        return self._colors[self._faces_vt.long()]

    @property
    def texture(self) -> Optional[torch.Tensor]:
        return self._texture

    # ------------------------------------------------------------------
    # reference-compatible scalar accessors
    # ------------------------------------------------------------------

    def get_vertex(self, index: int):
        colors = None
        if self._colors is not None:
            colors = self._colors[index].cpu().numpy()
        return (self._vertices[index].cpu().numpy(), colors,
                self._normals[index].cpu().numpy())

    def get_triangle(self, index: int):
        colors = None
        if self._colors is not None:
            colors = self.colors_by_triangles[index].cpu().numpy()
        return (self.vertices_by_triangles[index].cpu().numpy(), colors,
                self.normals_by_triangles[index].cpu().numpy())

    def n_triangles(self) -> int:
        return int(self._faces_v.shape[0])

    def n_vertices(self) -> int:
        return int(self._vertices.shape[0])

    def get_mean_vertex(self) -> np.ndarray:
        return self._mean_vertex.cpu().numpy()

    def get_max_span(self) -> float:
        return float(self._max_span)


def fit_model(model: Model) -> None:
    """Center, unit-scale and push to z=1 (reference ``run.py:30-33``)."""
    model.shift(-model.get_mean_vertex())
    model.scale(1.0 / model.get_max_span())
    model.shift([0.0, 0.0, 1.0])
