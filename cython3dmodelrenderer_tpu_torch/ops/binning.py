"""Per-triangle plane rows and tile spans (the stage feeding the binner).

Counterpart of ``plane_data`` in ``cython3dmodelrenderer_tpu/ops/
binning.py:52-142``. Everything the rasterizer needs per triangle is affine
in screen (x, y): the three barycentric edge functions
``λ_i = A_i·x + B_i·y + C_i`` (the reference's own formula,
``py filler:176-178``, divided through by each λ's denominator), the depth
plane, and one plane per attribute channel. They pack into one float32 row
per triangle.

Row layout (unchanged from the JAX package): 12 plane coefficients
``[A0 B0 C0 A1 B1 C1 A2 B2 C2 Az Bz Cz]``, the clipped ceil-bbox
``[xl xr yl yr]``, then ``(A, B, C)`` for each attribute channel — 6
channels ``B G R nx ny nz`` (34 columns) or the 3 colour channels
(25 columns) in frames that never read normals.
"""
from __future__ import annotations

import torch

from ..config import RenderConfig
from .raster_ref import bbox_ceil

IDX_BBOX = 12          # xl, xr, yl, yr
IDX_ATTRS = 16
N_ATTRS = 6


def row_width(n_attrs: int) -> int:
    return IDX_ATTRS + 3 * n_attrs


def plane_data(tris_screen: torch.Tensor, active: torch.Tensor,
               config: RenderConfig, tile_h: int, tile_w: int,
               colors: torch.Tensor = None, normals: torch.Tensor = None):
    """Packed plane rows (T, 16 + 3·channels) f32 and tile spans.

    Returns ``(rows, tx0, cx, ty0, cy, counts)``; the spans are int32 and a
    culled or empty-bbox triangle gets a zero span.
    """
    w, h = config.width, config.height
    x0, y0 = tris_screen[:, 0, 0], tris_screen[:, 0, 1]
    x1, y1 = tris_screen[:, 1, 0], tris_screen[:, 1, 1]
    x2, y2 = tris_screen[:, 2, 0], tris_screen[:, 2, 1]
    z0, z1, z2 = tris_screen[:, 0, 2], tris_screen[:, 1, 2], tris_screen[:, 2, 2]

    def coeffs(xa, ya, xb, yb, xc, yc):
        # λ around vertex a with edge b→c, sign of the reference's own
        # denominator kept so the λ ≥ 0 test is the reference's
        d = (xb - xc) * (ya - yc) - (yb - yc) * (xa - xc)
        a = -(yb - yc) / d
        b = (xb - xc) / d
        c = ((yb - yc) * xc - (xb - xc) * yc) / d
        return a, b, c

    a0, b0, c0 = coeffs(x0, y0, x1, y1, x2, y2)
    a1, b1, c1 = coeffs(x1, y1, x2, y2, x0, y0)
    a2, b2, c2 = coeffs(x2, y2, x0, y0, x1, y1)

    az = a0 * z0 + a1 * z1 + a2 * z2
    bz = b0 * z0 + b1 * z1 + b2 * z2
    cz = c0 * z0 + c1 * z1 + c2 * z2

    xl, xr, yl, yr = bbox_ceil(tris_screen[..., :2], w, h)

    # SAFETY INVARIANT (binning.py:92-101): a culled/empty triangle's row
    # carries an empty bbox, so it fails every pixel's bbox test even if a
    # consumer reads it for a tile it was never binned into.
    nonempty = active & (xr > xl) & (yr > yl)
    zero = torch.zeros_like(xl)
    xl = torch.where(nonempty, xl, zero)
    xr = torch.where(nonempty, xr, zero)
    yl = torch.where(nonempty, yl, zero)
    yr = torch.where(nonempty, yr, zero)

    cols = [a0, b0, c0, a1, b1, c1, a2, b2, c2, az, bz, cz,
            xl.to(torch.float32), xr.to(torch.float32),
            yl.to(torch.float32), yr.to(torch.float32)]
    if colors is not None:
        vals = colors if normals is None else torch.cat([colors, normals], dim=2)
        v0, v1, v2 = vals[:, 0], vals[:, 1], vals[:, 2]          # (T, n_ch)
        acoef = a0[:, None] * v0 + a1[:, None] * v1 + a2[:, None] * v2
        bcoef = b0[:, None] * v0 + b1[:, None] * v1 + b2[:, None] * v2
        ccoef = c0[:, None] * v0 + c1[:, None] * v1 + c2[:, None] * v2
        for ch in range(vals.shape[2]):
            cols += [acoef[:, ch], bcoef[:, ch], ccoef[:, ch]]
    rows = torch.stack(cols, dim=1).contiguous()

    minus_one = torch.full_like(xl, -1)
    tx0 = torch.where(nonempty, xl // tile_w, zero)
    tx1 = torch.where(nonempty, (xr - 1) // tile_w, minus_one)
    ty0 = torch.where(nonempty, yl // tile_h, zero)
    ty1 = torch.where(nonempty, (yr - 1) // tile_h, minus_one)
    cx = torch.clamp(tx1 - tx0 + 1, min=0)
    cy = torch.clamp(ty1 - ty0 + 1, min=0)
    return rows, tx0, cx, ty0, cy, cx * cy
