"""The plain reference renderer: one view, plain PyTorch, no bins.

It renders what the program's frame and sweep paths render, from the
arrays the benchmark hands both sides, by the upstream rules the program
keeps: pose ``v @ Rᵀ + shift`` (Euler XYZ, degrees), cull (a zero 2-D
cross product, or a mean vertex-normal z >= 0), perspective projection,
barycentric planes, the clipped ceil bbox, coverage ``λ >= 0``, depth range
``0 <= z <= 1``, a strict-< depth test with exact ties to the lowest
triangle, Lambert with ``clip(dot(n, l) / (|n| + 1e-6), 0, 1)``, and the
uint8 cast by int32 truncation then ``& 255``.

Every product and sum is written out in the program's order and rounded
on its own (elementwise PyTorch ops, no matmul), and square roots and
divisions are IEEE, so on float32 the image is the program's bit for bit.
Instead of tiles and bins, each triangle is evaluated at every pixel of
its clipped ceil bbox, and a pixel keeps the least ``(z bits) << 32 |
triangle`` key of its covered fragments, which is the strict-< walk's
winner in ascending triangle order.

``dtype`` runs the same arithmetic in another precision: bfloat16 is the
benchmark's control (the reference in the program's place, computed in
the precision below the float32 the configurations state).
"""
from __future__ import annotations

import math

import numpy as np
import torch

#: the tile grid on which ``stats`` counts (triangle, tile) pairs
TILE_H, TILE_W = 16, 32
#: fragments evaluated in one pass
FRAGMENTS_PER_PASS = 1 << 22
NO_WINNER = torch.iinfo(torch.int64).max


def projection_matrix(fov: float, aspect: float, z_near: float,
                      z_far: float) -> list:
    """The upstream 4x4 row-vector projection, float32 entries."""
    f = 1.0 / np.tan(fov / 2.0 / 180.0 * np.pi)
    q = z_far / (z_far - z_near)
    return np.array([[f / aspect, 0.0, 0.0, 0.0], [0.0, f, 0.0, 0.0],
                     [0.0, 0.0, q, 1.0], [0.0, 0.0, -z_near * q, 0.0]],
                    dtype=np.float32).tolist()


def _dot3(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def _matmul3(a, b):
    return torch.stack([_dot3(a, b[:, j]) for j in range(3)], dim=-1)


def rotation_transpose(angles) -> torch.Tensor:
    """``(Rx @ Ry @ Rz)ᵀ`` of Euler XYZ degrees, float32 on the host, each
    entry rounded as a float32 product chain."""
    ang = torch.as_tensor(np.asarray(angles, np.float32)) * (math.pi / 180.0)
    c, s = torch.cos(ang), torch.sin(ang)
    one, zero = torch.ones(()), torch.zeros(())
    rx = torch.stack([torch.stack([one, zero, zero]),
                      torch.stack([zero, c[0], s[0]]),
                      torch.stack([zero, -s[0], c[0]])])
    ry = torch.stack([torch.stack([c[1], zero, s[1]]),
                      torch.stack([zero, one, zero]),
                      torch.stack([-s[1], zero, c[1]])])
    rz = torch.stack([torch.stack([c[2], s[2], zero]),
                      torch.stack([-s[2], c[2], zero]),
                      torch.stack([zero, zero, one])])
    return _matmul3(_matmul3(rx, ry), rz).T


def frame_light(direction) -> np.ndarray:
    """A frame's light: the negated direction over its norm (float32)."""
    light = -np.asarray(direction, np.float32)
    return light / np.linalg.norm(light)


def sweep_light(direction) -> np.ndarray:
    """A sweep's light: the frame's light normalised once more by
    ``sqrt((x² + y²) + z²)`` in float32, as the sweep takes the drawer's
    unit vector."""
    light = frame_light(direction)
    x, y, z = light
    return light / np.sqrt((x * x + y * y) + z * z)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root (CPU PyTorch's is not; NumPy's is)."""
    if x.device.type != "cpu" or x.dtype != torch.float32:
        return torch.sqrt(x)
    return torch.from_numpy(np.sqrt(x.contiguous().numpy()))


def lambert(color, normal, light):
    """``color * clip(dot(n, l) / (|n| + 1e-6), 0, 1)``; the dot starts
    from +0.0."""
    lx, ly, lz = (float(v) for v in light)
    nx, ny, nz = normal[..., 0], normal[..., 1], normal[..., 2]
    dot = ((nx * lx + 0.0) + ny * ly) + nz * lz
    shadow = dot / (_sqrt((nx * nx + ny * ny) + nz * nz) + 1e-6)
    shadow = torch.where(shadow < 0.0, 0.0, shadow)
    shadow = torch.where(shadow > 1.0, 1.0, shadow)
    return color * shadow[..., None]


def cast_u8(color: torch.Tensor) -> torch.Tensor:
    return (color.float().to(torch.int32) & 255).to(torch.uint8)


def _ceil_clip(v: torch.Tensor, hi: int) -> torch.Tensor:
    return torch.clamp(torch.ceil(v), 0, hi).nan_to_num(0.0).to(torch.int32)


def _planes(ts: torch.Tensor):
    """The three λ planes (A, B, C) of screen triangles (T, 3, 3)."""
    x = [ts[:, k, 0] for k in range(3)]
    y = [ts[:, k, 1] for k in range(3)]
    out = []
    for a, b, c in ((0, 1, 2), (1, 2, 0), (2, 0, 1)):
        xa, ya, xb, yb, xc, yc = x[a], y[a], x[b], y[b], x[c], y[c]
        d = (xb - xc) * (ya - yc) - (yb - yc) * (xa - xc)
        out.append((-(yb - yc) / d, (xb - xc) / d,
                    ((yb - yc) * xc - (xb - xc) * yc) / d))
    return out


def _attr_plane(lam, vals):
    """(A, B, C) of per-vertex values (T, 3, C) under the λ planes."""
    (a0, b0, c0), (a1, b1, c1), (a2, b2, c2) = lam
    v0, v1, v2 = vals[:, 0], vals[:, 1], vals[:, 2]
    return ((a0[:, None] * v0 + a1[:, None] * v1) + a2[:, None] * v2,
            (b0[:, None] * v0 + b1[:, None] * v1) + b2[:, None] * v2,
            (c0[:, None] * v0 + c1[:, None] * v1) + c2[:, None] * v2)


def render_view(vertices: torch.Tensor, faces: torch.Tensor,
                normals: torch.Tensor, colors: torch.Tensor, camera: dict,
                light=None, pose=None, dtype: torch.dtype = torch.float32):
    """One view: ``(image (H, W, 3) uint8, stats)``.

    ``vertices``, ``normals``, ``colors`` (V, 3) and ``faces`` (T, 3) as the
    benchmark built them, on the device to render on. ``camera``: width,
    height, fov, z_near, z_far. ``light``: the pre-negated unit light
    (``frame_light`` / ``sweep_light``) or None (colours unlit). ``pose``:
    None, or (Euler XYZ degrees, shift) applied as the sweep applies it.
    ``stats``
    counts the triangles, the (triangle, tile) pairs on the 16 x 32 tile
    grid and the pixels of the bboxes those pairs cover.
    """
    dev = vertices.device
    w, h = int(camera["width"]), int(camera["height"])
    f = faces.long()
    tv = vertices.to(dtype)[f]
    tn = normals.to(dtype)[f]
    tc = colors.to(dtype)[f]
    if pose is not None:
        angles, shift = pose
        rt = rotation_transpose(angles).to(dev, dtype)
        sh = torch.as_tensor(np.asarray(shift, np.float32)).to(dev, dtype)
        tv = _matmul3(tv, rt) + sh
        tn = _matmul3(tn, rt)
    # cull on the posed, unprojected triangles
    e1 = tv[:, 1, :2] - tv[:, 0, :2]
    e2 = tv[:, 2, :2] - tv[:, 0, :2]
    cross = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
    mean_nz = ((tn[:, 0, 2] + tn[:, 1, 2]) + tn[:, 2, 2]) / 3.0
    active = (cross != 0.0) & ~(mean_nz >= 0.0)
    # projection
    pm = projection_matrix(camera["fov"], h / w, camera["z_near"],
                           camera["z_far"])
    x, y, z = tv[..., 0], tv[..., 1], tv[..., 2]
    p = [((x * pm[0][j] + y * pm[1][j]) + z * pm[2][j]) + pm[3][j]
         for j in range(4)]
    ts = torch.stack([(p[0] / p[3] + 1.0) * (w / 2.0),
                      (p[1] / p[3] + 1.0) * (h / 2.0), p[2] / p[3]], dim=-1)
    lam = _planes(ts)
    zp = tuple((lam[0][k] * ts[:, 0, 2] + lam[1][k] * ts[:, 1, 2])
               + lam[2][k] * ts[:, 2, 2] for k in range(3))
    vals = tc if light is None else torch.cat([tc, tn], dim=2)
    attrs = _attr_plane(lam, vals)
    xl, xr = _ceil_clip(ts[..., 0].amin(1), w), _ceil_clip(ts[..., 0].amax(1), w)
    yl, yr = _ceil_clip(ts[..., 1].amin(1), h), _ceil_clip(ts[..., 1].amax(1), h)
    live = active & (xr > xl) & (yr > yl)

    tri = torch.nonzero(live).squeeze(1)
    bw = (xr - xl)[tri].to(torch.int64)
    bh = (yr - yl)[tri].to(torch.int64)
    area = (bw * bh).cpu().numpy()
    key_min = torch.full((h * w,), NO_WINNER, dtype=torch.int64, device=dev)
    ends = np.cumsum(area)
    start = 0
    while start < len(tri):
        base = int(ends[start - 1]) if start else 0
        stop = max(int(np.searchsorted(ends, base + FRAGMENTS_PER_PASS,
                                       side="right")), start + 1)
        n = int(ends[stop - 1]) - base
        sel = torch.arange(start, stop, device=dev)
        frag = torch.repeat_interleave(sel, torch.as_tensor(
            area[start:stop], device=dev), output_size=n)
        k = torch.arange(n, device=dev) - (
            torch.as_tensor(ends[start:stop] - area[start:stop],
                            device=dev) - base)[frag - start]
        t = tri[frag]
        dy = torch.div(k, bw[frag], rounding_mode="floor")
        ix = xl[t].to(torch.int64) + (k - dy * bw[frag])
        iy = yl[t].to(torch.int64) + dy
        px, py = ix.to(dtype), iy.to(dtype)
        good = torch.ones(n, dtype=torch.bool, device=dev)
        for a, b, c in lam:
            good &= (px * a[t] + (py * b[t] + c[t])) >= 0
        zf = px * zp[0][t] + (py * zp[1][t] + zp[2][t])
        good &= (zf >= 0.0) & (zf <= 1.0)
        key = (((zf.float() + 0.0).view(torch.int32).to(torch.int64) << 32)
               | t)
        key_min.scatter_reduce_(0, iy * w + ix,
                                torch.where(good, key, NO_WINNER), "amin")
        start = stop

    has = key_min != NO_WINNER
    win = torch.where(has, key_min & 0xFFFFFFFF, 0)
    flat = torch.arange(h * w, device=dev)
    px, py = (flat % w).to(dtype), (flat // w).to(dtype)
    chans = [torch.where(has, px * attrs[0][win, ch]
                         + (py * attrs[1][win, ch] + attrs[2][win, ch]) + 0.0,
                         torch.zeros((), dtype=dtype, device=dev))
             for ch in range(vals.shape[2])]
    color = torch.stack(chans[:3], dim=-1)
    if light is not None:
        color = lambert(color, torch.stack(chans[3:], dim=-1), light)
    image = cast_u8(color).reshape(h, w, 3)

    tx0, tx1 = xl // TILE_W, (xr - 1) // TILE_W
    ty0, ty1 = yl // TILE_H, (yr - 1) // TILE_H
    pairs = torch.where(live, (tx1 - tx0 + 1) * (ty1 - ty0 + 1), 0)
    stats = {"triangles": int(faces.shape[0]), "pairs": int(pairs.sum()),
             "window_pixels": int(area.sum())}
    return image, stats
