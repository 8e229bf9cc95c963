"""Ratio-form rasterizer: the ``"ratio"`` backend and the port's oracle.

Counterpart of ``cython3dmodelrenderer_tpu/ops/raster_ref.py`` (the JAX
``backend="jnp"``), with the reference rasterization rules
(``crender/py/pixel_buffer_filler/advanced_pixel_buffer_filler.py:108-240``):

* candidate pixels = the ceil-based bounding box, clipped to the image:
  ``x ∈ [clip(ceil(min x)), clip(ceil(max x)))``;
* coverage = all three barycentric coordinates ≥ 0, each λ by the
  reference's own edge formula (one denominator per λ, the *ratio form*;
  the tile kernel B1 evaluates planes instead);
* depth = ``λ · z`` with the [0, 1] range check;
* depth resolve = strict <, exact ties to the lowest triangle index: each
  pixel's winner is the lexicographic minimum of ``(z, priority)``.

Two phases, as in JAX: ``rasterize`` finds each pixel's winning triangle
and z, ``_resolve`` recomputes the winner's λ at each pixel and
interpolates its attributes. JAX scans triangle chunks over a static
``bbox_size`` window from each bbox's corner (a larger bbox is cut at the
window), takes each chunk's per-pixel z minimum, then the least priority
at that z, and merges the chunk into the carry with a strict <. The port
evaluates the same fragments — each triangle's bbox cut at the window, no
other pixel of the window, which JAX rejects anyway — packed one after
another, ``FRAGMENTS_PER_PASS`` a pass of whole chunks, and reaches the
same result order-free: per pixel the least z value, then the least
triangle at that value; passes merge by a strict <.

Every scatter is an integer ``scatter_reduce``, so the result is the same
on the CPU and on the card. Where -0.0 and +0.0 tie, JAX's z-buffer
carries the bits of the first chunk holding the least value: -0.0 when
that chunk holds a -0.0 fragment (XLA's CPU scatter-min keeps -0.0 over
+0.0), else +0.0. That chunk is the winner's, so the port asks whether the
winner's chunk holds a -0.0 candidate. The colour is the lowest
triangle's, whichever zero won.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..config import RenderConfig

INT_MAX = torch.iinfo(torch.int32).max
_NEG_ZERO_BITS = torch.iinfo(torch.int32).min     # bits of -0.0 as int32
#: fragments evaluated per pass of ``rasterize`` (whole chunks a pass)
FRAGMENTS_PER_PASS = 1 << 21


def _clipped_ceil(v: torch.Tensor, hi: int) -> torch.Tensor:
    # NaN (a vertex on the camera plane) becomes 0, like XLA's f32→s32
    return torch.clamp(torch.ceil(v), 0, hi).nan_to_num(0.0).to(torch.int32)


def bbox_ceil(tri_xy: torch.Tensor, width: int, height: int):
    """Clipped ceil-based bbox per triangle (reference py filler:131-134).

    tri_xy: (T, 3, 2) screen xy. Returns (xl, xr, yl, yr) int32 tensors; the
    candidate pixel range is [xl, xr) × [yl, yr).
    """
    x = tri_xy[..., 0]
    y = tri_xy[..., 1]
    xl = _clipped_ceil(x.amin(dim=1), width)
    xr = _clipped_ceil(x.amax(dim=1), width)
    yl = _clipped_ceil(y.amin(dim=1), height)
    yr = _clipped_ceil(y.amax(dim=1), height)
    return xl, xr, yl, yr


def barycentric(tri_xy: torch.Tensor, px: torch.Tensor, py: torch.Tensor):
    """The reference's three-lambda edge formula (py filler:176-178).

    tri_xy: (..., 3, 2); px/py broadcastable against the leading dims.
    Returns (l0, l1, l2), each shaped like the broadcast.
    """
    x0, y0 = tri_xy[..., 0, 0], tri_xy[..., 0, 1]
    x1, y1 = tri_xy[..., 1, 0], tri_xy[..., 1, 1]
    x2, y2 = tri_xy[..., 2, 0], tri_xy[..., 2, 1]
    l0 = (((x1 - x2) * (py - y2) - (y1 - y2) * (px - x2))
          / ((x1 - x2) * (y0 - y2) - (y1 - y2) * (x0 - x2)))
    l1 = (((x2 - x0) * (py - y0) - (y2 - y0) * (px - x0))
          / ((x2 - x0) * (y1 - y0) - (y2 - y0) * (x1 - x0)))
    l2 = (((x0 - x1) * (py - y1) - (y0 - y1) * (px - x1))
          / ((x0 - x1) * (y2 - y1) - (y0 - y1) * (x2 - x1)))
    return l0, l1, l2


def interp3(l0: torch.Tensor, l1: torch.Tensor, l2: torch.Tensor,
            attrs: torch.Tensor) -> torch.Tensor:
    """``Σ_k λ_k · attrs[..., k, :]`` as ``(λ0·a0 + λ1·a1) + λ2·a2``: the
    JAX einsums ``pk,pkd->pd`` and ``hwk,kd->hwd``. ``attrs`` is
    (..., 3, D) against λ shaped like its leading dims."""
    return ((l0[..., None] * attrs[..., 0, :] + l1[..., None] * attrs[..., 1, :])
            + l2[..., None] * attrs[..., 2, :])


def _passes(chunk_frags, budget: int):
    """[first, end) chunk ranges holding at most ``budget`` fragments each
    (or one chunk, when a chunk alone holds more)."""
    out, first, total = [], 0, 0
    for c, n in enumerate(chunk_frags):
        if c > first and total + n > budget:
            out.append((first, c))
            first, total = c, 0
        total += n
    out.append((first, len(chunk_frags)))
    return out


def window_fragments(tris_screen: torch.Tensor, active: torch.Tensor,
                     config: RenderConfig, bbox_size: int):
    """Each triangle's fragments: its clipped ceil bbox cut at the
    ``bbox_size`` window from its corner, none when inactive. Returns
    int64 (xl, yl, window width, fragment count), each (T,)."""
    xl, xr, yl, yr = (v.to(torch.int64) for v in
                      bbox_ceil(tris_screen[..., :2], config.width,
                                config.height))
    on = active.to(torch.bool)
    ww = torch.where(on, (torch.minimum(xr, xl + bbox_size) - xl).clamp(min=0),
                     0)
    wh = torch.where(on, (torch.minimum(yr, yl + bbox_size) - yl).clamp(min=0),
                     0)
    return xl, yl, ww, ww * wh


def _fragments(tris_screen, xl, yl, ww, n_frag, first: int, end: int,
               n: int, width: int):
    """Triangles [first, end)'s ``n`` fragments, triangle after triangle,
    row-major over each one's ``ww``-wide window: (pixel, triangle, z, good).
    """
    dev = tris_screen.device
    nf = n_frag[first:end]
    tri = torch.repeat_interleave(torch.arange(first, end, device=dev), nf,
                                  output_size=n)
    offset = (torch.arange(n, device=dev)
              - (torch.cumsum(nf, 0) - nf)[tri - first])
    w_tri = ww[tri]
    dy = offset // w_tri
    px = xl[tri] + (offset - dy * w_tri)
    py = yl[tri] + dy
    ts = tris_screen[tri]
    l0, l1, l2 = barycentric(ts[:, :, :2], px.to(torch.float32),
                             py.to(torch.float32))
    z = (l0 * ts[:, 0, 2] + l1 * ts[:, 1, 2]) + l2 * ts[:, 2, 2]
    good = (l0 >= 0) & (l1 >= 0) & (l2 >= 0) & (z >= 0.0) & (z <= 1.0)
    return py * width + px, tri, z, good


def rasterize(tris_screen: torch.Tensor, colors: torch.Tensor,
              normals: torch.Tensor, active: torch.Tensor,
              config: RenderConfig, bbox_size: int = 64,
              chunk: int = 512) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Rasterize projected triangles into (color, z, normal) G-buffers.

    ``tris_screen`` (T, 3, 3) screen-space vertices (x, y, depth);
    ``colors`` / ``normals`` (T, 3, 3) per-vertex attributes; ``active``
    (T,) bool. ``bbox_size`` is the per-triangle window side (see
    ``required_bbox_size``), ``chunk`` the triangles of JAX's scan step (it
    decides only which zero a -0.0/+0.0 tie keeps). All tensors on one
    device; the work stays there, with one host read (the fragments of
    each chunk, to size the passes). Returns (color (H, W, 3), z (H, W, 1)
    with ``z_init`` background, normal (H, W, 3)) float32.
    """
    h, w = config.height, config.width
    hw = h * w
    dev = tris_screen.device
    t = tris_screen.shape[0]
    tris_screen = tris_screen.to(torch.float32)
    xl, yl, ww, n_frag = window_fragments(tris_screen, active, config,
                                          bbox_size)
    t_pad = -(-max(t, 1) // chunk) * chunk
    chunk_frags = torch.cat([n_frag, n_frag.new_zeros(t_pad - t)]).reshape(
        -1, chunk).sum(1).tolist()

    zbuf = torch.full((hw,), torch.inf, dtype=torch.float32, device=dev)
    pbuf = torch.full((hw,), INT_MAX, dtype=torch.int64, device=dev)
    for c0, c1 in _passes(chunk_frags, FRAGMENTS_PER_PASS):
        n = sum(chunk_frags[c0:c1])
        if n == 0:
            continue
        pix, tri, z, good = _fragments(tris_screen, xl, yl, ww, n_frag,
                                       c0 * chunk, min(c1 * chunk, t), n, w)
        # the least z value a pixel (±0 folded), then the least triangle
        # at that value
        key = torch.where(good, (z + 0.0).view(torch.int32), INT_MAX)
        kz = torch.full((hw,), INT_MAX, dtype=torch.int32, device=dev)
        kz.scatter_reduce_(0, pix, key, "amin")
        cand = good & (key == kz[pix])
        pc = torch.full((hw,), INT_MAX, dtype=torch.int64, device=dev)
        pc.scatter_reduce_(0, pix, torch.where(cand, tri, INT_MAX), "amin")
        # a zero keeps its sign when the winner's chunk holds a -0.0
        neg = (cand & (z.view(torch.int32) == _NEG_ZERO_BITS)
               & (tri // chunk == pc[pix] // chunk))
        nz = torch.zeros((hw,), dtype=torch.int32, device=dev)
        nz.scatter_reduce_(0, pix, neg.to(torch.int32), "amax")
        zc = torch.where(kz == INT_MAX, torch.inf, kz.view(torch.float32))
        zc = torch.where(nz > 0, -0.0, zc)
        # strict < beats the earlier passes; a tie keeps the earlier one
        better = zc < zbuf
        zbuf = torch.where(better, zc, zbuf)
        pbuf = torch.where(better, pc, pbuf)
    return _resolve(tris_screen, colors, normals, zbuf, pbuf, config)


def _resolve(tris_screen, colors, normals, zbuf, pbuf, config: RenderConfig):
    """Phase 2: gather each pixel's winning triangle, interpolate its
    attributes at the pixel."""
    h, w = config.height, config.width
    dev = tris_screen.device
    if colors.shape[0] == 0:        # empty scene → background everywhere
        return (torch.zeros((h, w, 3), dtype=torch.float32, device=dev),
                torch.full((h, w, 1), config.z_init, dtype=torch.float32,
                           device=dev),
                torch.zeros((h, w, 3), dtype=torch.float32, device=dev))
    has = pbuf != INT_MAX
    win = torch.where(has, pbuf, 0)
    twin = tris_screen[win]                                  # (HW, 3, 3)
    flat = torch.arange(h * w, device=dev)
    px = (flat % w).to(torch.float32)
    py = (flat // w).to(torch.float32)
    l0, l1, l2 = barycentric(twin[..., :2], px, py)
    interp_c = interp3(l0, l1, l2, colors.to(torch.float32)[win])
    interp_n = interp3(l0, l1, l2, normals.to(torch.float32)[win])
    color = torch.where(has[:, None], interp_c, 0.0).reshape(h, w, 3)
    normal = torch.where(has[:, None], interp_n, 0.0).reshape(h, w, 3)
    zout = torch.where(has, zbuf, config.z_init).reshape(h, w, 1)
    return color, zout, normal


def required_bbox_size(tris_screen: torch.Tensor, active: torch.Tensor,
                       config: RenderConfig, bucket: int = 32) -> int:
    """Smallest ``bucket`` multiple covering every active triangle's
    clipped bbox (one host read)."""
    if tris_screen.shape[0] == 0:
        return bucket
    xl, xr, yl, yr = bbox_ceil(tris_screen[..., :2], config.width,
                               config.height)
    wmax = torch.where(active, xr - xl, 0).max()
    hmax = torch.where(active, yr - yl, 0).max()
    need = max(int(torch.maximum(wmax, hmax)), 1)
    return -(-need // bucket) * bucket
