"""Tile rasterizer — kernel B1 and its plain version — and the frame path.

``raster_tiles`` replaces ``cython3dmodelrenderer_tpu/ops/raster_pallas.py::
_raster_tiles_grouped`` (TPU kernel ``_make_kernel_grouped``,
``raster_pallas.py:293``). On a CUDA tensor it launches ``csrc/raster.cu``
(one block per 16x32 tile, one thread per pixel; see the source for its
design and what bounds it); on a CPU tensor it runs ``raster_tiles_plain``.
Both write straight into (H, W, C) image layout, so the JAX package's
group-packed output, ``assemble_u8_image``, ``_pos_of_tiles`` and the
grouped unpacks have no counterpart.

Semantics held (ROADMAP "Ground rules"): ceil bbox ``[xl, xr) × [yl, yr)``,
coverage ``λ ≥ 0``, depth range ``0 ≤ z ≤ 1``, strict-< depth test with
exact ties to the lowest triangle index, ``z_init`` background, u8 by int32
truncation then ``& 255``, Lambert in the kernel's operation order.

``render_frame`` is the counterpart of ``raster_pallas.render_frame``
(``:1309-1440``) for posts ``"none"``, ``"u8"`` and ``"lambert_u8"``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import cuda_build
from ..config import RenderConfig
from . import binning
from .binsort import bin_pairs
from .illumination import cast_u8, lambert_shade
from .projection import project_to_screen, visibility_masks
from .sort import sort_i32, sort_i32_plain

TILE_H = 16
TILE_W = 32
POSTS = ("none", "u8", "lambert_u8")
PLAIN_CHUNK = 2048     # pairs per pass of the plain raster (x 512 fragments)

GBuffers = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _plane(rows: torch.Tensor, col: int, px: torch.Tensor,
           py: torch.Tensor) -> torch.Tensor:
    """``px*A + (py*B + C)`` for the plane starting at column ``col``;
    ``rows`` is (n, R) against (n, m) pixels or (n,) against (n,)."""
    a, b, c = rows[:, col], rows[:, col + 1], rows[:, col + 2]
    if px.dim() == 2:
        a, b, c = a[:, None], b[:, None], c[:, None]
    return px * a + (py * b + c)


def _good(rows: torch.Tensor, px: torch.Tensor, py: torch.Tensor):
    """(z, mask) of every candidate: λ ≥ 0, ceil bbox, 0 ≤ z ≤ 1."""
    l0 = _plane(rows, 0, px, py)
    l1 = _plane(rows, 3, px, py)
    l2 = _plane(rows, 6, px, py)
    z = _plane(rows, 9, px, py)
    b = [rows[:, binning.IDX_BBOX + i][:, None] for i in range(4)]
    good = ((l0 >= 0) & (l1 >= 0) & (l2 >= 0)
            & (px >= b[0]) & (px < b[1]) & (py >= b[2]) & (py < b[3])
            & (z >= 0.0) & (z <= 1.0))
    return z, good


def _check_inputs(rows, pair_tri, tile_starts, tile_counts, n_tiles, n_attrs):
    if rows.dtype != torch.float32 or rows.dim() != 2 or not rows.is_contiguous():
        raise ValueError("rows must be a contiguous (T, R) float32 tensor")
    if rows.shape[1] < binning.row_width(n_attrs):
        raise ValueError(f"rows have {rows.shape[1]} columns; {n_attrs} "
                         f"attributes need {binning.row_width(n_attrs)}")
    for name, t in (("pair_tri", pair_tri), ("tile_starts", tile_starts),
                    ("tile_counts", tile_counts)):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int32 tensor")
        if t.device != rows.device:
            raise ValueError(f"{name} is on {t.device}, rows on {rows.device}")
    if tile_starts.numel() != n_tiles or tile_counts.numel() != n_tiles:
        raise ValueError(f"tile tables must have {n_tiles} entries")
    if n_attrs not in (3, 6):
        raise ValueError("n_attrs must be 3 or 6")


def background(height: int, width: int, z_init: float,
                device) -> GBuffers:
    return (torch.zeros((height, width, 3), dtype=torch.float32, device=device),
            torch.full((height, width, 1), z_init, dtype=torch.float32,
                       device=device),
            torch.zeros((height, width, 3), dtype=torch.float32, device=device))


def raster_tiles_plain(rows: torch.Tensor, pair_tri: torch.Tensor,
                       tile_starts: torch.Tensor, tile_counts: torch.Tensor,
                       ntx: int, nty: int, height: int, width: int,
                       n_attrs: int, z_init: float, light=None,
                       gbuffer: bool = True, image: bool = False
                       ) -> Tuple[Optional[GBuffers], Optional[torch.Tensor]]:
    """The plain version of ``raster_tiles``, ``PLAIN_CHUNK`` pairs a pass.

    Every pair is evaluated over its tile's 512 pixels; the per-pixel
    ``(z, rank)`` lexicographic minimum (rank = position in the tile's
    ascending bin) comes from two ``scatter_reduce("amin")`` passes, then
    the winner's planes are evaluated at each pixel.
    """
    _check_inputs(rows, pair_tri, tile_starts, tile_counts, ntx * nty, n_attrs)
    dev = rows.device
    hw = height * width
    counts = tile_counts.to(torch.int64)
    n = int(counts.sum())
    pair_tile = torch.repeat_interleave(torch.arange(ntx * nty, device=dev),
                                        counts, output_size=n)
    off = torch.cumsum(counts, 0) - counts
    pos = (tile_starts.to(torch.int64)[pair_tile]
           + torch.arange(n, device=dev) - off[pair_tile])
    local = torch.arange(TILE_H * TILE_W, device=dev)

    def fragments(p0: int, p1: int):
        tile = pair_tile[p0:p1]
        g = rows[pair_tri[pos[p0:p1]].to(torch.int64)]
        xi = ((tile % ntx) * TILE_W)[:, None] + (local % TILE_W)[None, :]
        yi = ((tile // ntx) * TILE_H)[:, None] + (local // TILE_W)[None, :]
        z, good = _good(g, xi.to(torch.float32), yi.to(torch.float32))
        inside = (xi < width) & (yi < height)
        good = good & inside
        pix = torch.where(inside, yi * width + xi, hw)        # hw: dump slot
        return pix.reshape(-1), z, good

    inf = float("inf")
    zmin = torch.full((hw + 1,), inf, dtype=torch.float32, device=dev)
    for p0 in range(0, n, PLAIN_CHUNK):
        pix, z, good = fragments(p0, min(n, p0 + PLAIN_CHUNK))
        zmin.scatter_reduce_(0, pix, torch.where(good, z, inf).reshape(-1), "amin")
    rmin = torch.full((hw + 1,), n, dtype=torch.int64, device=dev)
    for p0 in range(0, n, PLAIN_CHUNK):
        p1 = min(n, p0 + PLAIN_CHUNK)
        pix, z, good = fragments(p0, p1)
        cand = good.reshape(-1) & (z.reshape(-1) == zmin[pix])
        rank = pos[p0:p1, None].expand(-1, TILE_H * TILE_W).reshape(-1)
        rmin.scatter_reduce_(0, pix, torch.where(cand, rank, n), "amin")

    has = rmin[:hw] < n
    wtri = pair_tri[rmin[:hw].clamp(max=max(n - 1, 0))].to(torch.int64) \
        if n else torch.zeros(hw, dtype=torch.int64, device=dev)
    flat = torch.arange(hw, device=dev)
    px = (flat % width).to(torch.float32)
    py = (flat // width).to(torch.float32)
    wrows = rows[wtri] if rows.shape[0] else \
        torch.zeros((hw, rows.shape[1]), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    # + 0.0: a -0.0 plane value reads +0.0, as in the kernel
    attrs = [torch.where(has, _plane(wrows, binning.IDX_ATTRS + 3 * ch, px, py)
                         + 0.0, zero) for ch in range(n_attrs)]
    attrs += [torch.zeros_like(px)] * (6 - n_attrs)
    color = torch.stack(attrs[:3], dim=-1).reshape(height, width, 3)
    normal = torch.stack(attrs[3:], dim=-1).reshape(height, width, 3)
    gbuf = img = None
    if gbuffer:
        zbuf = torch.where(has, _plane(wrows, 9, px, py),
                           torch.full_like(px, z_init))
        gbuf = (color, zbuf.reshape(height, width, 1), normal)
    if image:
        # a pixel without a winner has zero colour and normal → shades to 0
        img = cast_u8(color if light is None
                      else lambert_shade(color, normal, light))
    return gbuf, img


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("raster")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.raster_launch.argtypes = [p, i, p, p, p, i, i, i, i, i, f, i, f, f, f,
                                  p, p, p, p, i, p]
    lib.raster_launch.restype = ctypes.c_int
    return lib


def raster_tiles(rows: torch.Tensor, pair_tri: torch.Tensor,
                 tile_starts: torch.Tensor, tile_counts: torch.Tensor,
                 ntx: int, nty: int, height: int, width: int,
                 n_attrs: int, z_init: float, light=None,
                 gbuffer: bool = True, image: bool = False
                 ) -> Tuple[Optional[GBuffers], Optional[torch.Tensor]]:
    """Rasterize binned plane rows into a G-buffer and/or a u8 image.

    ``rows`` (T, R) float32 plane rows; tile t's candidates are the
    triangle ids ``pair_tri[tile_starts[t]:][:tile_counts[t]]`` in ascending
    order. Returns ``(gbuf, image)``: ``gbuf`` = (color (H, W, 3),
    z (H, W, 1), normal (H, W, 3)) float32 when ``gbuffer``, ``image`` =
    (H, W, 3) uint8 BGR when ``image`` — Lambert-shaded with ``light`` (the
    pre-negated unit direction) when given, which needs ``n_attrs == 6``.
    CUDA tensors launch kernel B1, CPU tensors run ``raster_tiles_plain``.
    """
    if rows.device.type == "cpu":
        return raster_tiles_plain(rows, pair_tri, tile_starts, tile_counts,
                                  ntx, nty, height, width, n_attrs, z_init,
                                  light, gbuffer, image)
    if rows.device.type != "cuda":
        raise ValueError(f"raster_tiles: unsupported device {rows.device}")
    _check_inputs(rows, pair_tri, tile_starts, tile_counts, ntx * nty, n_attrs)
    if light is not None and n_attrs != 6:
        raise ValueError("Lambert shading needs the 6-attribute rows")
    if not (gbuffer or image):
        raise ValueError("raster_tiles must emit a G-buffer or an image")
    if ntx * TILE_W < width or nty * TILE_H < height:
        raise ValueError("the tile grid does not cover the image")
    dev = rows.device
    # the kernel writes every pixel of the image: no background fill
    gbuf = img = None
    gbuf_ptrs = (None, None, None)
    if gbuffer:
        gbuf = tuple(torch.empty((height, width, c), dtype=torch.float32,
                                 device=dev) for c in (3, 1, 3))
        gbuf_ptrs = tuple(t.data_ptr() for t in gbuf)
    if image:
        img = torch.empty((height, width, 3), dtype=torch.uint8, device=dev)
    lx, ly, lz = (float(v) for v in light) if light is not None else (0.0,) * 3
    lib = _lib()
    err = lib.raster_launch(
        rows.data_ptr(), rows.shape[1], pair_tri.data_ptr(),
        tile_starts.data_ptr(), tile_counts.data_ptr(), ntx, nty, height,
        width, n_attrs, z_init, int(light is not None), lx, ly, lz,
        *gbuf_ptrs, img.data_ptr() if img is not None else None,
        dev.index, cuda_build.stream_handle(dev))
    cuda_build.check(lib, err, "raster_tiles (csrc/raster.cu)")
    raster_tiles.launches += 1
    return gbuf, img


#: kernel launches made by ``raster_tiles`` (one per call on a CUDA tensor)
raster_tiles.launches = 0


def render_frame(tri_verts: torch.Tensor, tri_norms: torch.Tensor,
                 tri_colors: torch.Tensor, config: RenderConfig,
                 post: str = "none", light=None, gbuffer: bool = False,
                 backend: str = "torch"
                 ) -> Tuple[Optional[GBuffers], Optional[torch.Tensor], int]:
    """One frame: cull + project → plane rows → bins (B2) → raster (B1).

    ``post``: ``"none"`` (G-buffer only), ``"u8"`` (uint8 colour image) or
    ``"lambert_u8"`` (Lambert-shaded with ``light``, the pre-negated unit
    direction). ``gbuffer=True`` also emits the G-buffer for a post frame.
    ``backend``: ``"cuda"`` goes through the kernels' wrappers, ``"torch"``
    through their plain versions. Returns ``(gbuf, image, n_pairs)``; the
    frame reads one scalar back to the host (its pair total, which sizes
    the bins exactly).
    """
    if post == "fast_lambert_u8":
        raise NotImplementedError("fast-shade frames are ROADMAP queue A item 9")
    if post not in POSTS:
        raise ValueError(f"unknown post {post!r}")
    if post == "lambert_u8" and light is None:
        raise ValueError("post='lambert_u8' needs a light direction")
    sort, raster = ((sort_i32, raster_tiles) if backend == "cuda"
                    else (sort_i32_plain, raster_tiles_plain))
    h, w = config.height, config.width
    ntx, nty = -(-w // TILE_W), -(-h // TILE_H)
    emit_gbuf = post == "none" or gbuffer
    want_img = post != "none"
    if tri_verts.shape[0] == 0:                 # empty scene → background
        dev = tri_verts.device
        img = (torch.zeros((h, w, 3), dtype=torch.uint8, device=dev)
               if want_img else None)
        return (background(h, w, config.z_init, dev) if emit_gbuf else None,
                img, 0)
    degenerate, backfacing = visibility_masks(tri_verts, tri_norms)
    active = ~degenerate & ~backfacing
    tris_screen = project_to_screen(tri_verts, config)
    # hot u8 frames never read normals: 3 attribute channels (25 columns)
    n_attrs = 3 if (post == "u8" and not emit_gbuf) else binning.N_ATTRS
    rows, tx0, cx, ty0, cy, counts = binning.plane_data(
        tris_screen, active, config, TILE_H, TILE_W,
        colors=tri_colors.to(torch.float32),
        normals=None if n_attrs == 3 else tri_norms)
    total = int(counts.sum())                   # the frame's one host read
    pair_tri, tile_starts, tile_counts = bin_pairs(tx0, cx, ty0, cy, ntx, nty,
                                                   total, sort=sort)
    gbuf, img = raster(rows, pair_tri, tile_starts, tile_counts, ntx, nty, h, w,
                       n_attrs, config.z_init,
                       light=light if post == "lambert_u8" else None,
                       gbuffer=emit_gbuf, image=want_img)
    return gbuf, img, total
