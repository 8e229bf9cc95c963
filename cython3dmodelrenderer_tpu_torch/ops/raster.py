"""Tile rasterizer — kernel B1 and its plain version — and the frame path.

``raster_tiles`` replaces ``cython3dmodelrenderer_tpu/ops/raster_pallas.py::
_raster_tiles_grouped`` (TPU kernel ``_make_kernel_grouped``,
``raster_pallas.py:293``). On a CUDA tensor it launches ``csrc/raster.cu``
(one block per 16x32 tile; each candidate is evaluated only at the pixels
of its ceil bbox's window in the tile, and a pixel's winner is the minimum
of one (z bits, triangle) key; see the source for its design and what
bounds it); on a CPU tensor it runs ``raster_tiles_plain``, which takes
the minimum of the same key.
Both write straight into (H, W, C) image layout, so the JAX package's
group-packed output, ``assemble_u8_image``, ``_pos_of_tiles`` and the
grouped unpacks have no counterpart.

The same kernel also replaces the one-tile-per-step TPU kernel B3
(``raster_pallas.py::_make_kernel``, ``:142``, launched by
``_raster_tiles``): B3 computes what B1 computes over one tile's ascending
bin and differs only in layout, and B1 already reads per-tile runs of
triangle ids with no packing limit. So B3's counterpart is B1 launched on
the counting-sort bins of ``binsort.bin_sort`` (B4); B3's flat stripe
G-buffer and its unpacks (``_gbuffers_from_packed``, ``unpack_channels``,
``packed_background``) have none, and B1 shades and quantises in-kernel
where the JAX un-grouped frame derives its image from the G-buffers in
XLA — the same bytes.

Semantics held (ROADMAP "Ground rules"): ceil bbox ``[xl, xr) × [yl, yr)``,
coverage ``λ ≥ 0``, depth range ``0 ≤ z ≤ 1``, strict-< depth test with
exact ties to the lowest triangle index, ``z_init`` background, u8 by int32
truncation then ``& 255``, Lambert in the kernel's operation order.

``render_frame`` is the counterpart of ``raster_pallas.render_frame``
(``:1309-1440``) for posts ``"none"``, ``"u8"``, ``"lambert_u8"`` and
``"fast_lambert_u8"``, and ``rasterize`` of ``raster_pallas.rasterize``
(``:1450``). ``route_bins`` routes a frame's bins, or a view batch's, as
``raster_pallas._stage_b`` does (``:1139-1161``).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import cuda_build
from ..config import RenderConfig
from ..utils import timing
from . import binning
from .binsort import bin_pairs, bin_sort, bin_sort_plain, grouped_limits_ok
from .frontend import frame_planes, frame_planes_plain
from .illumination import cast_u8, lambert_shade
from .sort import sort_i32, sort_i32_plain

TILE_H = 16
TILE_W = 32
POSTS = ("none", "u8", "lambert_u8", "fast_lambert_u8")
PLAIN_CHUNK = 2048     # pairs per pass of the plain raster (x 512 fragments)
PLAIN_PIXELS = 1 << 20  # pixels per pass of the plain raster's winner stage
#: the JAX filler's lane-subgroup packing (``raster_pallas.GROUP``); a
#: ``group > 1`` frame inside ``grouped_limits_ok`` takes the sort route
GROUP = 16
#: f32 instructions the walk of csrc/raster.cu needs per (pair, pixel)
#: of the pair's window (its ceil bbox in the tile and the image): 4 planes
#: of 2 multiplies + 2 adds, 10 compares (3 λ, 4 bbox, 2 z range, the depth
#: test), 2 selects; the walk visits no other pixel
INSTR_PER_BBOX_PIXEL = 28
#: the key of "no winner" in the plain version's per-pixel minimum
NO_WINNER = torch.iinfo(torch.int64).max

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


def _frame_shape(n_views: int, height: int, width: int, c: int):
    """(H, W, C) for one view, (V, H, W, C) for a batch."""
    return (height, width, c) if n_views == 1 else (n_views, height, width, c)


def _binned_pairs(tile_starts: torch.Tensor, tile_counts: torch.Tensor):
    """(pair_tile, pos, n): each binned pair's stacked tile id and its
    position in ``pair_tri``, tile by tile in bin order."""
    dev = tile_counts.device
    counts = tile_counts.to(torch.int64)
    n = int(counts.sum())
    pair_tile = torch.repeat_interleave(torch.arange(counts.numel(), device=dev),
                                        counts, output_size=n)
    off = torch.cumsum(counts, 0) - counts
    pos = (tile_starts.to(torch.int64)[pair_tile]
           + torch.arange(n, device=dev) - off[pair_tile])
    return pair_tile, pos, n


def bbox_window(lo: torch.Tensor, hi: torch.Tensor, t0: torch.Tensor,
                t1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``window()`` of csrc/raster.cu: (first, count) of the integer
    positions p in [t0, t1) that pass ``p >= lo`` and ``p < hi`` for float32
    bounds. The ceil bounds are clamped to [t0, t1] as floats before any
    conversion; a NaN or empty pair (``not lo < hi``) holds none."""
    f0, f1 = t0.to(torch.float32), t1.to(torch.float32)
    first = torch.fmin(torch.fmax(torch.ceil(lo), f0), f1).to(torch.int64)
    end = torch.fmin(torch.fmax(torch.ceil(hi), f0), f1).to(torch.int64)
    count = torch.where(lo < hi, (end - first).clamp(min=0),
                        torch.zeros_like(first))
    return first, count


def walk_instructions(rows: torch.Tensor, pair_tri: torch.Tensor,
                      tile_starts: torch.Tensor, tile_counts: torch.Tensor,
                      ntx: int, nty: int, height: int, width: int,
                      n_views: int = 1) -> int:
    """The f32 instructions these bins need for the walk:
    ``INSTR_PER_BBOX_PIXEL`` for each binned pair at each pixel of its
    window, the in-image pixels of its tile inside its triangle's ceil bbox
    (``bbox_window``). The winners' epilogue is left out."""
    tpv = ntx * nty
    pair_tile, pos, n = _binned_pairs(tile_starts, tile_counts)
    if n == 0:
        return 0
    tile = pair_tile % tpv
    bbox = rows[pair_tri[pos].to(torch.int64),
                binning.IDX_BBOX:binning.IDX_BBOX + 4]
    x0, y0 = (tile % ntx) * TILE_W, (tile // ntx) * TILE_H
    _fx, wx = bbox_window(bbox[:, 0], bbox[:, 1], x0,
                          torch.clamp(x0 + TILE_W, max=width))
    _fy, wy = bbox_window(bbox[:, 2], bbox[:, 3], y0,
                          torch.clamp(y0 + TILE_H, max=height))
    return INSTR_PER_BBOX_PIXEL * int((wx * wy).sum())


def raster_tiles_plain(rows: torch.Tensor, pair_tri: torch.Tensor,
                       tile_starts: torch.Tensor, tile_counts: torch.Tensor,
                       ntx: int, nty: int, height: int, width: int,
                       n_attrs: int, z_init: float, light=None,
                       gbuffer: bool = True, image: bool = False,
                       n_views: int = 1
                       ) -> Tuple[Optional[GBuffers], Optional[torch.Tensor]]:
    """The plain version of ``raster_tiles``, ``PLAIN_CHUNK`` pairs a pass.

    Every pair is evaluated over its tile's 512 pixels. A pixel's winner is
    the minimum of the kernel's int64 key ``bits(z + 0.0) << 32 | triangle``
    over its covered fragments (one ``scatter_reduce("amin")``): a covered
    z lies in [0, 1], so this is the (z, triangle) lexicographic minimum
    that a strict-< walk of the ascending bin keeps. Then the winner's
    planes are evaluated at each pixel.
    """
    tpv = ntx * nty
    _check_inputs(rows, pair_tri, tile_starts, tile_counts, tpv * n_views,
                  n_attrs)
    dev = rows.device
    hw = height * width
    n_pix = n_views * hw
    pair_tile, pos, n = _binned_pairs(tile_starts, tile_counts)
    local = torch.arange(TILE_H * TILE_W, device=dev)

    key_min = torch.full((n_pix + 1,), NO_WINNER, dtype=torch.int64,
                         device=dev)
    for p0 in range(0, n, PLAIN_CHUNK):
        p1 = min(n, p0 + PLAIN_CHUNK)
        view, tile = pair_tile[p0:p1] // tpv, pair_tile[p0:p1] % tpv
        tri = pair_tri[pos[p0:p1]].to(torch.int64)
        xi = ((tile % ntx) * TILE_W)[:, None] + (local % TILE_W)[None, :]
        yi = ((tile // ntx) * TILE_H)[:, None] + (local // TILE_W)[None, :]
        z, good = _good(rows[tri], xi.to(torch.float32), yi.to(torch.float32))
        inside = (xi < width) & (yi < height)
        # n_pix: the dump slot of pixels outside their view's image
        pix = torch.where(inside, view[:, None] * hw + yi * width + xi, n_pix)
        # + 0.0 folds -0.0 into +0.0; a covered z's bits are >= 0
        key = ((z + 0.0).view(torch.int32).to(torch.int64) << 32) | tri[:, None]
        key_min.scatter_reduce_(0, pix.reshape(-1),
                                torch.where(good & inside, key,
                                            NO_WINNER).reshape(-1), "amin")

    # the winners' planes at every pixel, PLAIN_PIXELS pixels a pass (the
    # gathered winner rows are 136 B a pixel)
    color = torch.zeros((n_pix, 3), dtype=torch.float32, device=dev)
    normal = torch.zeros((n_pix, 3), dtype=torch.float32, device=dev)
    zbuf = torch.full((n_pix,), z_init, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for q0 in range(0, n_pix if n else 0, PLAIN_PIXELS):
        q1 = min(n_pix, q0 + PLAIN_PIXELS)
        has = key_min[q0:q1] != NO_WINNER
        wrows = rows[torch.where(has, key_min[q0:q1] & 0xFFFFFFFF, 0)]
        flat = torch.arange(q0, q1, device=dev) % hw      # view-relative
        px = (flat % width).to(torch.float32)
        py = (flat // width).to(torch.float32)
        for ch in range(n_attrs):
            # + 0.0: a -0.0 plane value reads +0.0, as in the kernel
            out = color if ch < 3 else normal
            out[q0:q1, ch % 3] = torch.where(
                has, _plane(wrows, binning.IDX_ATTRS + 3 * ch, px, py) + 0.0,
                zero)
        zbuf[q0:q1] = torch.where(has, _plane(wrows, 9, px, py),
                                  torch.full_like(px, z_init))
    color = color.reshape(_frame_shape(n_views, height, width, 3))
    normal = normal.reshape(color.shape)
    gbuf = img = None
    if gbuffer:
        gbuf = (color, zbuf.reshape(_frame_shape(n_views, height, width, 1)),
                normal)
    if image:
        # a pixel without a winner has zero colour and normal → shades to 0
        img = cast_u8(color if light is None
                      else lambert_shade(color, normal, light))
    return gbuf, img


def _lib() -> ctypes.CDLL:
    return bind(cuda_build.load("raster"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare ``raster_launch``'s C signature on a loaded library."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.raster_launch.argtypes = [p, i, p, p, p, i, i, i, i, i, i, f, i, f, f,
                                  f, p, p, p, p, i, p]
    lib.raster_launch.restype = ctypes.c_int
    return lib


def raster_tiles(rows: torch.Tensor, pair_tri: torch.Tensor,
                 tile_starts: torch.Tensor, tile_counts: torch.Tensor,
                 ntx: int, nty: int, height: int, width: int,
                 n_attrs: int, z_init: float, light=None,
                 gbuffer: bool = True, image: bool = False, n_views: int = 1
                 ) -> Tuple[Optional[GBuffers], Optional[torch.Tensor]]:
    """Rasterize binned plane rows into a G-buffer and/or a u8 image.

    ``rows`` (T, R) float32 plane rows; tile t's candidates are the
    triangle ids ``pair_tri[tile_starts[t]:][:tile_counts[t]]`` in ascending
    order. Returns ``(gbuf, image)``: ``gbuf`` = (color (H, W, 3),
    z (H, W, 1), normal (H, W, 3)) float32 when ``gbuffer``, ``image`` =
    (H, W, 3) uint8 BGR when ``image`` — Lambert-shaded with ``light`` (the
    pre-negated unit direction) when given, which needs ``n_attrs == 6``.

    ``n_views > 1`` renders a view batch in the same one launch: the tile
    tables hold ``n_views * ntx * nty`` entries, view v's tiles at
    ``v * ntx * nty + local``, and every output gains a leading
    ``(n_views,)`` axis. Pixel coordinates are view-relative, so each view
    renders as it would alone.
    CUDA tensors launch kernel B1, CPU tensors run ``raster_tiles_plain``.
    """
    if rows.device.type == "cpu":
        return raster_tiles_plain(rows, pair_tri, tile_starts, tile_counts,
                                  ntx, nty, height, width, n_attrs, z_init,
                                  light, gbuffer, image, n_views)
    if rows.device.type != "cuda":
        raise ValueError(f"raster_tiles: unsupported device {rows.device}")
    _check_inputs(rows, pair_tri, tile_starts, tile_counts,
                  ntx * nty * n_views, n_attrs)
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
        gbuf = tuple(torch.empty(_frame_shape(n_views, height, width, c),
                                 dtype=torch.float32, device=dev)
                     for c in (3, 1, 3))
        gbuf_ptrs = tuple(t.data_ptr() for t in gbuf)
    if image:
        img = torch.empty(_frame_shape(n_views, height, width, 3),
                          dtype=torch.uint8, device=dev)
    lx, ly, lz = (float(v) for v in light) if light is not None else (0.0,) * 3
    lib = _lib()
    err = lib.raster_launch(
        rows.data_ptr(), rows.shape[1], pair_tri.data_ptr(),
        tile_starts.data_ptr(), tile_counts.data_ptr(), ntx, nty, n_views,
        height, width, n_attrs, z_init, int(light is not None), lx, ly, lz,
        *gbuf_ptrs, img.data_ptr() if img is not None else None,
        dev.index, cuda_build.stream_handle(dev))
    cuda_build.check(lib, err, "raster_tiles (csrc/raster.cu)")
    timing.counters["launch.raster"] += 1
    return gbuf, img


def view_row_stride(nty: int, group: int) -> int:
    """``raster_pallas.view_row_stride`` (``:121``): a view's tile rows
    padded to a multiple of ``group``. The port stacks views without this
    padding; it enters only the budget test of ``route_bins``."""
    return -(-nty // group) * group


def route_bins(tx0: torch.Tensor, cx: torch.Tensor, ty0: torch.Tensor,
               cy: torch.Tensor, ntx: int, nty: int, total: int, group: int,
               backend: str, n_views: int = 1):
    """The bins of ``n_views`` stacked ``ntx x nty`` frames (spans on the
    ``ntx x n_views·nty`` grid), routed as ``raster_pallas._stage_b``
    routes them: a ``group > 1`` batch inside ``grouped_limits_ok`` — with
    ``n_views·T`` triangles, the pair total as ``slot_cap`` and
    ``n_views · view_row_stride(nty, group)`` tile rows, as the JAX sweep
    lays views out — takes the sort route (B2 + ``searchsorted``), every
    other one the counting-sort route (B4). Both give the same bins.
    ``backend``: ``"cuda"`` = the kernels' wrappers, ``"torch"`` = their
    plain versions."""
    sort, count_sort = ((sort_i32, bin_sort) if backend == "cuda"
                        else (sort_i32_plain, bin_sort_plain))
    if group > 1 and grouped_limits_ok(tx0.shape[0], total, ntx,
                                       n_views * view_row_stride(nty, group)):
        return bin_pairs(tx0, cx, ty0, cy, ntx, n_views * nty, total, sort=sort)
    return count_sort(tx0, cx, ty0, cy, ntx, n_views * nty, total)


def render_frame(tri_verts: torch.Tensor, tri_norms: torch.Tensor,
                 tri_colors: torch.Tensor, config: RenderConfig,
                 post: str = "none", light=None, gbuffer: bool = False,
                 backend: str = "torch", group: int = 1,
                 stats: Optional[dict] = None
                 ) -> Tuple[Optional[GBuffers], Optional[torch.Tensor], int]:
    """One frame: the front end (F1: cull, project, plane rows, spans) →
    bins → raster (B1).

    ``post``: ``"none"`` (G-buffer only), ``"u8"`` (uint8 colour image),
    ``"lambert_u8"`` (Lambert-shaded with ``light``, the pre-negated unit
    direction) or ``"fast_lambert_u8"`` (fast shade: Lambert baked into the
    vertex colours, then the u8 post over 3 attribute channels — a
    Gouraud image, the z-buffer bit-equal to exact mode, the normal
    G-buffer zeros; ``raster_pallas.py:1340-1350``). ``gbuffer=True``
    also emits the G-buffer for a post frame.
    ``backend``: ``"cuda"`` goes through the kernels' wrappers, ``"torch"``
    through their plain versions. ``group`` routes the bins
    (``route_bins``); both routes give the same bins, so the same pixels.
    Returns ``(gbuf, image, n_pairs)``; the frame reads one scalar back to
    the host (its pair total, which sizes the bins exactly). A ``stats``
    dict receives ``"active_tiles"``, the count of nonempty tiles as a
    device scalar (no host read).
    """
    if post not in POSTS:
        raise ValueError(f"unknown post {post!r}")
    fast = post == "fast_lambert_u8"
    if post in ("lambert_u8", "fast_lambert_u8") and light is None:
        raise ValueError(f"post={post!r} needs a light direction")
    raster = raster_tiles if backend == "cuda" else raster_tiles_plain
    h, w = config.height, config.width
    ntx, nty = -(-w // TILE_W), -(-h // TILE_H)
    emit_gbuf = post == "none" or gbuffer
    want_img = post != "none"
    if tri_verts.shape[0] == 0:                 # empty scene → background
        dev = tri_verts.device
        img = (torch.zeros((h, w, 3), dtype=torch.uint8, device=dev)
               if want_img else None)
        if stats is not None:
            stats["active_tiles"] = torch.zeros((), dtype=torch.int64,
                                                device=dev)
        return (background(h, w, config.z_init, dev) if emit_gbuf else None,
                img, 0)
    # hot u8 frames never read normals: 3 attribute channels (25 columns);
    # fast shade bakes Lambert into the vertex colours (Gouraud)
    n_attrs = (3 if fast or (post == "u8" and not emit_gbuf)
               else binning.N_ATTRS)
    planes = frame_planes if backend == "cuda" else frame_planes_plain
    with timing.span("front_end"):
        rows, tx0, cx, ty0, cy, _counts, total = planes(
            tri_verts, tri_norms, tri_colors, config, n_attrs, TILE_H, TILE_W,
            shade=light if fast else None)
    with timing.span("pair_total"):
        total = int(total)                      # the frame's one host read
    with timing.span("bins"):
        bins = route_bins(tx0, cx, ty0, cy, ntx, nty, total, group, backend)
    if stats is not None:
        stats["active_tiles"] = (bins[2] > 0).sum()
    with timing.span("raster"):
        gbuf, img = raster(rows, *bins, ntx, nty, h, w, n_attrs,
                           config.z_init,
                           light=light if post == "lambert_u8" else None,
                           gbuffer=emit_gbuf, image=want_img)
    return gbuf, img, total


def rasterize(tris_screen: torch.Tensor, colors: torch.Tensor,
              normals: torch.Tensor, active: torch.Tensor,
              config: RenderConfig) -> GBuffers:
    """Rasterize projected triangles into (color, z, normal) G-buffers.

    Counterpart of ``raster_pallas.rasterize`` (``:1450``): ``tris_screen``
    (T, 3, 3) screen-space vertices, ``colors`` / ``normals`` (T, 3, 3)
    per-vertex attributes, ``active`` (T,) bool. Always the counting-sort
    route (B4, then B1), through the kernels' wrappers, so CUDA tensors
    launch the kernels and CPU tensors run their plain versions; one host
    read (the pair total).
    """
    h, w = config.height, config.width
    if tris_screen.shape[0] == 0:
        return background(h, w, config.z_init, tris_screen.device)
    ntx, nty = -(-w // TILE_W), -(-h // TILE_H)
    rows, tx0, cx, ty0, cy, counts = binning.plane_data(
        tris_screen, active, config, TILE_H, TILE_W,
        colors=colors.to(torch.float32), normals=normals)
    bins = bin_sort(tx0, cx, ty0, cy, ntx, nty, int(counts.sum()))
    gbuf, _img = raster_tiles(rows, *bins, ntx, nty, h, w, binning.N_ATTRS,
                              config.z_init)
    return gbuf
