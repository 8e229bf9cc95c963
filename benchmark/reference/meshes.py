"""Frozen mesh builders and the harness's posing, in NumPy.

``displaced_sphere`` and ``displaced_torus`` are copies of the scene
builders of ``chip_smoke.py``, kept here so that a change to the smoke
script cannot move the benchmark's meshes. ``displaced_sphere(64, 48)``
is also the rule of ``tools/make_igor_sphere.py``, the repository's
igor stand-in: the same vertices and triangles as
``assets/igor_sphere.obj`` once its quads are split.

``posed_states`` and ``centred_state`` pose a mesh as the upstream
README does (two Euler rotations, then a fit to unit span) and work out
smooth vertex normals; the benchmark hands the same arrays to the
program and to the reference.
"""
from __future__ import annotations

import numpy as np


def displaced_sphere(segments: int, rings: int):
    """Vertices and triangles of a displaced UV sphere (radius
    1 + 0.08 sin 6θ sin 5φ), quads fan-split, one vertex at each pole."""
    verts, index = [], {}
    for r in range(rings + 1):
        phi = np.pi * r / rings
        for s in range(segments):
            if r in (0, rings) and s > 0:
                continue
            theta = 2.0 * np.pi * s / segments
            rad = 1.0 + 0.08 * np.sin(6.0 * theta) * np.sin(5.0 * phi)
            index[(r, s)] = len(verts)
            verts.append((rad * np.sin(phi) * np.cos(theta), rad * np.cos(phi),
                          rad * np.sin(phi) * np.sin(theta)))

    def vid(r, s):
        return index[(r, 0 if r in (0, rings) else s % segments)]

    faces = []
    for r in range(rings):
        for s in range(segments):
            a, b = vid(r, s), vid(r, s + 1)
            c, d = vid(r + 1, s + 1), vid(r + 1, s)
            if r == 0:
                faces.append((a, c, d))
            elif r == rings - 1:
                faces.append((a, b, d))
            else:
                faces += [(a, b, c), (a, c, d)]
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)


def displaced_torus(nu: int, nv: int):
    """Vertices and triangles of a displaced torus: an (nu x nv)-quad grid
    wrapping both ways, R = 1, tube radius 0.45 (1 + 0.08 sin 6θ sin 5φ),
    each quad split into (a, b, c) and (a, c, d)."""
    theta = 2.0 * np.pi * np.arange(nu) / nu
    phi = 2.0 * np.pi * np.arange(nv) / nv
    th, ph = np.meshgrid(theta, phi, indexing="ij")
    r = 0.45 * (1.0 + 0.08 * np.sin(6.0 * th) * np.sin(5.0 * ph))
    ring = 1.0 + r * np.cos(ph)
    verts = np.stack([ring * np.cos(th), r * np.sin(ph), ring * np.sin(th)],
                     axis=-1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij")

    def vid(a, b):
        return (a % nu) * nv + b % nv

    a, b, c, d = vid(i, j), vid(i + 1, j), vid(i + 1, j + 1), vid(i, j + 1)
    faces = np.concatenate([np.stack([a, b, c], -1).reshape(-1, 3),
                            np.stack([a, c, d], -1).reshape(-1, 3)])
    return verts.astype(np.float32), faces.astype(np.int32)


BUILDERS = {"displaced_sphere": displaced_sphere,
            "displaced_torus": displaced_torus}


def build(mesh: dict):
    """(vertices, faces) of a config's ``mesh`` entry: ``builder`` names
    one of ``BUILDERS``, the other keys are its arguments."""
    args = {k: v for k, v in mesh.items() if k != "builder"}
    return BUILDERS[mesh["builder"]](**args)


def euler_matrix(angles_deg) -> np.ndarray:
    """``Rx @ Ry @ Rz`` of Euler XYZ degrees with the upstream model's
    ``[[c, s], [-s, c]]`` blocks; a vertex row turns as ``v @ R.T``."""
    ax, ay, az = np.radians(np.asarray(angles_deg, np.float64))
    cx, sx, cy, sy, cz, sz = (np.cos(ax), np.sin(ax), np.cos(ay), np.sin(ay),
                              np.cos(az), np.sin(az))
    rx = np.array([[1, 0, 0], [0, cx, sx], [0, -sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, sz, 0], [-sz, cz, 0], [0, 0, 1]])
    return rx @ ry @ rz


def vertex_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Unit mean of the adjacent faces' unit normals ``-cross(t1 - t0,
    t1 - t2)`` (the upstream face normal), float32."""
    v = vertices.astype(np.float64)
    t0, t1, t2 = v[faces[:, 0]], v[faces[:, 1]], v[faces[:, 2]]
    fn = -np.cross(t1 - t0, t1 - t2)
    fn /= np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-30)
    acc = np.zeros_like(v)
    for k in range(3):
        np.add.at(acc, faces[:, k], fn)
    acc /= np.maximum(np.linalg.norm(acc, axis=1, keepdims=True), 1e-30)
    return acc.astype(np.float32)


def base_vertices(vertices: np.ndarray, rotations) -> np.ndarray:
    """The README pose without its depth: each rotation in turn, then
    centred on the mean vertex and scaled to unit span (float64)."""
    v = vertices.astype(np.float64)
    for angles in rotations:
        v = v @ euler_matrix(angles).T
    v = v - v.mean(axis=0)
    return v / np.sqrt((v * v).sum(axis=1)).max()


def state(vertices, faces: np.ndarray, normals, colors: np.ndarray) -> dict:
    """The arrays ``Model.from_state`` takes: float32 vertices, normals and
    colours a vertex, one face table for all three."""
    return {"vertices": np.ascontiguousarray(vertices, np.float32),
            "faces_v": faces,
            "normals": np.ascontiguousarray(normals, np.float32),
            "faces_n": faces, "colors": colors, "faces_vt": faces}


def posed_states(vertices: np.ndarray, faces: np.ndarray, pose: dict,
                 angles_y, colors: np.ndarray):
    """One state a turntable angle: the README pose, a turn of ``angle``
    degrees about y, then ``pose["shift"]`` (the fitted model's depth).
    The normals are the README pose's, turned with the vertices."""
    base = base_vertices(vertices, pose["rotations"])
    normals = vertex_normals(base, faces).astype(np.float64)
    shift = np.asarray(pose["shift"], np.float64)
    turns = [euler_matrix([0.0, a, 0.0]).T for a in angles_y]
    return [state(base @ r + shift, faces, normals @ r, colors) for r in turns]


def centred_state(vertices: np.ndarray, faces: np.ndarray, pose: dict,
                  colors: np.ndarray) -> dict:
    """The README pose centred at the origin, for a sweep to pose."""
    base = base_vertices(vertices, pose["rotations"])
    return state(base, faces, vertex_normals(base, faces), colors)


def seeded_colors(n_vertices: int, rng: np.random.Generator) -> np.ndarray:
    """Per-vertex colours as texture sampling gives them: whole numbers
    0..255 in float32."""
    return rng.integers(0, 256, (n_vertices, 3)).astype(np.float32)
