"""Sequential NumPy oracle renderer — the port's test reference.

The port's own copy of ``cython3dmodelrenderer_tpu/utils/oracle.py`` (the
port imports nothing of the JAX package): an independent, deliberately
simple per-triangle implementation of the rasterization semantics
(reference ``crender/py/pixel_buffer_filler/advanced_pixel_buffer_filler.py``):
sequential triangles, strict-< z test, ceil bbox, λ ≥ 0 coverage, z ∈ [0, 1]
range check, Lambert shading, all in float32. NumPy only.
"""
from __future__ import annotations

import numpy as np

from ..config import RenderConfig


def projection_matrix_np(config: RenderConfig) -> np.ndarray:
    f = np.float32(1.0 / np.tan(config.fov / 2.0 / 180.0 * np.pi))
    a = np.float32(config.aspect)
    q = np.float32(config.z_far / (config.z_far - config.z_near))
    return np.array([
        [f / a, 0, 0, 0],
        [0, f, 0, 0],
        [0, 0, q, 1],
        [0, 0, -config.z_near * q, 0],
    ], dtype=np.float32)


def project_np(tri: np.ndarray, config: RenderConfig) -> np.ndarray:
    """(3,3) model-space triangle → (3,3) screen (x, y, depth)."""
    homo = np.concatenate([tri.astype(np.float32),
                           np.ones((3, 1), np.float32)], axis=1)
    p = homo @ projection_matrix_np(config)
    p[:, :3] /= p[:, 3:4]
    p[:, :2] += np.float32(1.0)
    p[:, 0] *= np.float32(config.width / 2.0)
    p[:, 1] *= np.float32(config.height / 2.0)
    return p[:, :3]


def render_oracle(tri_verts: np.ndarray, tri_colors: np.ndarray,
                  tri_normals: np.ndarray, config: RenderConfig,
                  order=None):
    """Sequential rasterization of (T,3,3) triangles.

    Returns (color (H,W,3) f32, z (H,W,1) f32, normal (H,W,3) f32).
    """
    h, w = config.height, config.width
    color = np.zeros((h, w, 3), np.float32)
    zbuf = np.full((h, w, 1), np.float32(config.z_init), np.float32)
    nbuf = np.zeros((h, w, 3), np.float32)

    t = tri_verts.shape[0]
    indices = range(t) if order is None else list(np.asarray(order))
    for i in indices:
        tri = np.asarray(tri_verts[i], np.float32)
        cols = np.asarray(tri_colors[i], np.float32)
        norms = np.asarray(tri_normals[i], np.float32)

        # degenerate cull (2D cross of unprojected edges == 0)
        e1 = tri[1, :2] - tri[0, :2]
        e2 = tri[2, :2] - tri[0, :2]
        if e1[0] * e2[1] - e1[1] * e2[0] == 0:
            continue
        # backface cull: mean vertex-normal z >= 0
        if np.mean(norms[:, 2], dtype=np.float32) >= 0:
            continue

        ts = project_np(tri, config)

        xl = int(np.clip(np.ceil(ts[:, 0].min()), 0, w))
        xr = int(np.clip(np.ceil(ts[:, 0].max()), 0, w))
        yl = int(np.clip(np.ceil(ts[:, 1].min()), 0, h))
        yr = int(np.clip(np.ceil(ts[:, 1].max()), 0, h))
        if xr <= xl or yr <= yl:
            continue

        xs = np.arange(xl, xr, dtype=np.float32)
        ys = np.arange(yl, yr, dtype=np.float32)
        px, py = np.meshgrid(xs, ys)

        x0, y0 = ts[0, 0], ts[0, 1]
        x1, y1 = ts[1, 0], ts[1, 1]
        x2, y2 = ts[2, 0], ts[2, 1]
        l0 = ((x1 - x2) * (py - y2) - (y1 - y2) * (px - x2)) / \
             ((x1 - x2) * (y0 - y2) - (y1 - y2) * (x0 - x2))
        l1 = ((x2 - x0) * (py - y0) - (y2 - y0) * (px - x0)) / \
             ((x2 - x0) * (y1 - y0) - (y2 - y0) * (x1 - x0))
        l2 = ((x0 - x1) * (py - y1) - (y0 - y1) * (px - x1)) / \
             ((x0 - x1) * (y2 - y1) - (y0 - y1) * (x2 - x1))
        inside = (l0 >= 0) & (l1 >= 0) & (l2 >= 0)

        z = l0 * ts[0, 2] + l1 * ts[1, 2] + l2 * ts[2, 2]
        ok = inside & (z >= 0) & (z <= 1)

        yy, xx = np.nonzero(ok)
        if len(yy) == 0:
            continue
        pyi = yy + yl
        pxi = xx + xl
        zi = z[yy, xx]
        closer = zi < zbuf[pyi, pxi, 0]
        pyi, pxi = pyi[closer], pxi[closer]
        if len(pyi) == 0:
            continue
        zi = zi[closer]
        bar = np.stack([l0[yy, xx][closer], l1[yy, xx][closer],
                        l2[yy, xx][closer]], axis=-1).astype(np.float32)
        zbuf[pyi, pxi, 0] = zi
        color[pyi, pxi] = bar @ cols
        nbuf[pyi, pxi] = bar @ norms
    return color, zbuf, nbuf


def lambert_np(color: np.ndarray, nbuf: np.ndarray,
               light_direction=(0, 0, 1)) -> np.ndarray:
    light = -np.asarray(light_direction, np.float32)
    light = light / np.linalg.norm(light)
    dot = np.sum(nbuf * light, axis=-1, keepdims=True)
    norm = np.linalg.norm(nbuf, axis=-1, keepdims=True)
    shadow = np.clip(dot / (norm + 1e-6), 0, 1)
    return color * shadow
