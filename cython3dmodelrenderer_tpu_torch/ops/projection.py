"""Geometry stage: batched perspective projection + culling masks.

Counterpart of ``cython3dmodelrenderer_tpu/ops/projection.py``. Projection
math (reference ``py filler:28-37, 84-105``): ``f = 1/tan(fov/2)``,
``a = h/w``, ``q = z_far/(z_far - z_near)``; homogeneous row-vector
multiply, perspective divide by w' (= the original z), NDC → screen
``(x+1)·w/2, (y+1)·h/2``; depth ``q·(z - z_near)/z``.

The 4x4 product is written out as multiply-adds in a fixed order
(``((x·P0j + y·P1j) + z·P2j) + P3j``) rather than a matmul, whose
reduction order and FMA use are the BLAS library's choice.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..config import RenderConfig


def projection_matrix(config: RenderConfig) -> np.ndarray:
    """The reference's 4x4 row-vector projection matrix (float32)."""
    f = 1.0 / np.tan(config.fov / 2.0 / 180.0 * np.pi)
    a = config.aspect
    q = config.z_far / (config.z_far - config.z_near)
    return np.array([
        [f / a, 0.0, 0.0, 0.0],
        [0.0,   f,   0.0, 0.0],
        [0.0,   0.0, q,   1.0],
        [0.0,   0.0, -config.z_near * q, 0.0],
    ], dtype=np.float32)


def project_to_screen(tri_vertices: torch.Tensor,
                      config: RenderConfig) -> torch.Tensor:
    """Project (T, 3, 3) model-space triangles to (T, 3, 3) screen coords
    (x_screen, y_screen, depth)."""
    pm = projection_matrix(config).tolist()
    v = tri_vertices.to(torch.float32)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    p = [((x * pm[0][j] + y * pm[1][j]) + z * pm[2][j]) + pm[3][j]
         for j in range(4)]
    w = p[3]
    sx = (p[0] / w + 1.0) * (config.width / 2.0)
    sy = (p[1] / w + 1.0) * (config.height / 2.0)
    return torch.stack([sx, sy, p[2] / w], dim=-1)


def visibility_masks(tri_vertices: torch.Tensor,
                     tri_normals: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(degenerate, backfacing) boolean masks of shape (T,) on *unprojected*
    triangles; a triangle is rasterized iff neither holds.

    * degenerate: 2D cross of the edges == 0 (reference py filler:59-61);
    * backfacing: mean vertex-normal z >= 0 (py filler:66-68).
    """
    e1 = tri_vertices[:, 1, :2] - tri_vertices[:, 0, :2]
    e2 = tri_vertices[:, 2, :2] - tri_vertices[:, 0, :2]
    cross = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
    nz = tri_normals[:, :, 2]
    mean_nz = ((nz[:, 0] + nz[:, 1]) + nz[:, 2]) / 3.0
    return cross == 0.0, mean_nz >= 0.0
