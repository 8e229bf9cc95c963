"""Model-space transforms and normal computation, on torch tensors.

Counterpart of ``cython3dmodelrenderer_tpu/ops/transforms.py``; same
reference semantics (``crender/py/data_structures/model.py``):

* rotation: ``[[c, s], [-s, c]]`` blocks assembled into Rx·Ry·Rz (degrees),
  applied as ``v @ Rᵀ`` (``model.py:228-255``);
* shift/scale are affine on vertices only; ``scale(keep_position=True)``
  recenters around the mean vertex (``model.py:212-226``);
* face normal ``-cross(t1 - t0, t1 - t2)``, normalized with a zero guard;
  vertex normal = normalized mean of the adjacent face normals after a
  greedy dedup in face order (``dot >= 1 - tol`` drops a normal,
  ``model.py:173-200``).

Every 3-term product is written as explicit multiply-adds in a fixed order
(``(a0*b0 + a1*b1) + a2*b2``) instead of ``matmul``/``einsum``, whose
reduction order and FMA use depend on the BLAS underneath.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from ..device import resolve_device
from .illumination import sqrt_rn


def _vec(values, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(values, dtype=np.float32),
                           device=like.device)


def shift(vertices: torch.Tensor, offset) -> torch.Tensor:
    """Translate all vertices. Reference ``model.py:212-215``."""
    return vertices + _vec(offset, vertices)


def scale(vertices: torch.Tensor, scale_coef, mean_vertex=None,
          keep_position: bool = True) -> torch.Tensor:
    """Scale vertices, optionally about their mean (``model.py:217-226``)."""
    coef = _vec(scale_coef, vertices)
    if keep_position:
        if mean_vertex is None:
            mean_vertex = vertices.mean(dim=0)
        return (vertices - mean_vertex) * coef + mean_vertex
    return vertices * coef


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(a0*b0 + a1*b1) + a2*b2`` over the last axis, no fused ops."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def _matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 3) rows of ``a`` times the 3x3 ``b``, as explicit dot products."""
    return torch.stack([_dot3(a, b[:, j]) for j in range(3)], dim=-1)


def rotation_matrix(angles, degrees: bool = True,
                    device=None) -> torch.Tensor:
    """The reference's Euler XYZ rotation matrix ``Rx @ Ry @ Rz``, on
    ``device`` (the current CUDA device by default; ``"cpu"`` for the
    CPU)."""
    ang = torch.as_tensor(np.asarray(angles, dtype=np.float32),
                          device=resolve_device(device))
    if degrees:
        ang = ang * (math.pi / 180.0)
    c, s = torch.cos(ang), torch.sin(ang)
    one = torch.ones((), device=ang.device)
    zero = torch.zeros((), device=ang.device)
    rx = torch.stack([torch.stack([one, zero, zero]),
                      torch.stack([zero, c[0], s[0]]),
                      torch.stack([zero, -s[0], c[0]])])
    ry = torch.stack([torch.stack([c[1], zero, s[1]]),
                      torch.stack([zero, one, zero]),
                      torch.stack([-s[1], zero, c[1]])])
    rz = torch.stack([torch.stack([c[2], s[2], zero]),
                      torch.stack([-s[2], c[2], zero]),
                      torch.stack([zero, zero, one])])
    return _matmul3(_matmul3(rx, ry), rz)


def rotate(vertices: torch.Tensor, angles, degrees: bool = True) -> torch.Tensor:
    """Rotate vertices: ``v @ Rᵀ`` (reference ``model.py:253``)."""
    r = rotation_matrix(angles, degrees=degrees, device=vertices.device)
    return _matmul3(vertices, r.T)


def mean_and_span(vertices: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean vertex and max distance from it (reference ``model.py:159-160``)."""
    mean = vertices.mean(dim=0)
    d = vertices - mean
    return mean, sqrt_rn(_dot3(d, d)).max()


def face_normals(tri_vertices: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """Per-face normals ``-cross(t1 - t0, t1 - t2)`` for (T, 3, 3) triangles.

    Faces with a repeated vertex get an exactly-zero normal, as the JAX
    package forces (its compiler fuses the cross product into FMAs, which
    leave a ~1e-9 residue); here the separate products cancel exactly
    anyway, and the guard keeps the two packages' rule the same.
    """
    t0, t1, t2 = tri_vertices[:, 0], tri_vertices[:, 1], tri_vertices[:, 2]
    a, b = t1 - t0, t1 - t2
    n = -torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                      a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                      a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=-1)
    same = ((t0 == t1).all(-1) | (t1 == t2).all(-1) | (t0 == t2).all(-1))
    n = torch.where(same[:, None], torch.zeros_like(n), n)
    return _normalize_rows(n) if normalize else n


def _normalize_rows(n: torch.Tensor) -> torch.Tensor:
    norm = sqrt_rn(_dot3(n, n))[..., None]
    return torch.where(norm == 0, n, n / torch.where(norm == 0, 1.0, norm))


def build_incidence(faces_v: np.ndarray, n_vertices: int) -> Tuple[np.ndarray, np.ndarray]:
    """(V, D) vertex→face incidence table in ascending face order, -1 padded.

    Host-side, once per topology; identical to the JAX package's table.
    Returns (table int32 (V, D), valid mask bool (V, D)).
    """
    faces_v = np.asarray(faces_v)
    t = faces_v.shape[0]
    vert_ids = faces_v.reshape(-1)
    vert_ids = np.where(vert_ids < 0, vert_ids + n_vertices, vert_ids)
    face_ids = np.repeat(np.arange(t, dtype=np.int64), 3)
    order = np.argsort(vert_ids, kind="stable")
    vs, fs = vert_ids[order], face_ids[order]
    counts = np.bincount(vs, minlength=n_vertices)
    d = max(int(counts.max()) if counts.size else 0, 1)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(len(vs)) - starts[vs]
    table = np.full((n_vertices, d), -1, dtype=np.int32)
    table[vs, slot] = fs
    return table, table >= 0


def vertex_normals(vertices: torch.Tensor, faces_v: torch.Tensor,
                   incidence: torch.Tensor, incidence_valid: torch.Tensor,
                   tol: float = 1e-6) -> torch.Tensor:
    """Smooth per-vertex normals with the reference's greedy dedup rule.

    For each vertex: gather adjacent face normals in face order, drop
    normal j when a kept normal i < j has ``dot(n_i, n_j) >= 1 - tol``,
    return ``normalize(mean(kept))``; vertices without faces get zero.
    The dedup walks the degree axis in a Python loop, one (V, D) column of
    pairwise dots at a time (a pole vertex of a UV sphere has degree 2x its
    segment count, so the full (V, D, D) table would be large).
    """
    if faces_v.shape[0] == 0:
        return torch.zeros_like(vertices)
    fn = face_normals(vertices[faces_v.long()], normalize=True)   # (T, 3)
    adj = fn[incidence.long().clamp(min=0)]                       # (V, D, 3)
    d = adj.shape[1]
    earlier = torch.arange(d, device=adj.device)
    kept = torch.zeros(incidence_valid.shape, dtype=torch.bool,
                       device=adj.device)
    for j in range(d):
        dots_j = _dot3(adj, adj[:, j:j + 1, :])                  # (V, D)
        collide = (dots_j >= 1.0 - tol) & kept & (earlier < j)[None, :]
        kept[:, j] = incidence_valid[:, j] & ~collide.any(dim=1)
    w = kept.to(adj.dtype)[..., None]
    count = w.sum(dim=1)
    mean = (adj * w).sum(dim=1) / count.clamp(min=1.0)
    mean = torch.where(count > 0, mean, torch.zeros_like(mean))
    return _normalize_rows(mean)
