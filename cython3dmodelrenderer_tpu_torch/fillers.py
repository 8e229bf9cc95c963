"""Pixel-buffer fillers: the rasterizers behind the ``Renderer``.

Counterpart of ``cython3dmodelrenderer_tpu/fillers.py``, with the
reference's filler hierarchy (``crender/{py,cy}/pixel_buffer_filler/``):

* ``PixelBufferFiller`` — the abstract per-triangle interface
  (``pixel_buffer_filler.py:7-11``);
* ``AdvancedPixelBufferFiller`` — the z-buffered whole-model rasterizer
  that owns its G-buffers (reference Version C,
  ``advanced_pixel_buffer_filler.pyx:92``), plus the per-triangle
  ``compute_triangle_statistics`` compat path of the pure-python reference
  filler (``py/advanced_pixel_buffer_filler.py:39``);
* ``EdgeOnlyPixelBufferFiller`` — wireframe (``ops/wireframe.py``).

Backends: ``"cuda"`` (the kernels) and ``"torch"`` (their plain versions)
render a frame through ``ops/raster.py::render_frame``; ``"ratio"``
through the ratio-form rasterizer ``ops/raster_ref.py`` (the JAX
``"jnp"``), on the filler's device.

Capacity: a binned frame sizes B4 from the largest pair total seen on its
tile grid and reads its own total once, after the raster's launch
(``raster.frame_stages``); a frame past that capacity runs its bins and
raster again before ``render`` returns, so every frame's bins are whole.
The JAX package's capacity buckets, background demand reader and
provisional frames have no counterpart: ``validate_capacity`` is true and
no frame is ever provisional.

A post frame (``"u8"``/``"lambert_u8"``/``"fast_lambert_u8"``) on a binned
backend writes only the uint8 image. Its G-buffer getters re-render the
retained inputs, in the same post mode, with G-buffer output on first
access — bit-identical, the kernels are deterministic — as the JAX filler's
``_materialize`` does (``fillers.py:452-486``). Ratio frames store their
G-buffers eagerly, as JAX's jnp frames do.
"""
from __future__ import annotations

from abc import abstractmethod
from typing import Optional, Tuple

import numpy as np
import torch

from .config import RenderConfig
from .device import resolve_backend, resolve_device
from .ops import raster, raster_ref, wireframe
from .ops.illumination import cast_u8, lambert_shade
from .ops.projection import project_to_screen, visibility_masks

#: fragments a ratio frame may hold per scan step (chunk x bbox²)
FRAGMENT_BUDGET = 1 << 20


class PixelBufferFiller:
    @abstractmethod
    def compute_triangle_statistics(self, triangle, colors, normals,
                                    color_buffer, z_buffer, n_buffer):
        ...


def ratio_chunk(bbox: int) -> int:
    """Triangles a step of a ratio frame whose bbox bucket is ``bbox``: a
    step's fragments (chunk x bbox²) within ``FRAGMENT_BUDGET``, 8 to 512
    (JAX ``fillers.py:436``)."""
    return max(8, min(512, FRAGMENT_BUDGET // (bbox * bbox)))


def check_fragment_budget(bbox: int, device: torch.device) -> None:
    """Refuse a ratio frame whose smallest scan step (8 triangles of
    ``bbox²`` fragments) exceeds ``FRAGMENT_BUDGET`` on a CUDA device, as
    JAX refuses its jnp frames on the accelerator (``fillers.py:426-435``)."""
    if 8 * bbox * bbox > FRAGMENT_BUDGET and device.type == "cuda":
        raise ValueError(
            f"scene's max triangle bbox ({bbox}px) exceeds the ratio "
            f"backend's fragment budget at this resolution; use "
            f"backend='cuda' (the default on the card) for huge-triangle "
            f"scenes")


class AdvancedPixelBufferFiller(PixelBufferFiller):
    """Z-buffered triangle rasterizer with device G-buffers.

    Constructor signature of the reference filler (``py filler:14``) plus
    ``backend`` (``"auto" | "cuda" | "torch" | "ratio"``, see
    ``RenderConfig``) and ``device``; ``n_threads`` is accepted and
    ignored. ``fast_shade=True`` (JAX ``fillers.py:197-208``) renders every
    ``"lambert_u8"`` frame of a binned backend as ``"fast_lambert_u8"``:
    Lambert baked per vertex (Gouraud), the z-buffer bit-equal to exact
    mode, the normal G-buffer zeros.
    """

    def __init__(self, h: int, w: int, fov: float = 90.0, z_near: float = 0.1,
                 z_far: float = 1000.0, n_threads: Optional[int] = None,
                 backend: str = "auto", device=None, fast_shade: bool = False):
        del n_threads
        self.device = resolve_device(device)
        self.config = RenderConfig(height=h, width=w, fov=fov, z_near=z_near,
                                   z_far=z_far, backend=backend)
        self.backend = resolve_backend(backend, self.device)
        self.fast_shade = fast_shade
        self._gbuf = None
        self._deferred = None          # (tv, tn, tc, post, light), post-only frame
        self._post_image: Optional[torch.Tensor] = None
        self.last_pairs = 0            # (triangle, tile) pairs of the last frame
        self._active_tiles = None      # its nonempty tiles (device scalar)
        self.reset_buffers()

    def get_size(self) -> Tuple[int, int]:
        return self.config.height, self.config.width

    def render_model(self, model, order: Optional[torch.Tensor] = None,
                     colors_override: Optional[torch.Tensor] = None,
                     post: str = "none", light=None,
                     keep_gbuffers: bool = False) -> None:
        """Rasterize the whole model into the filler's buffers.

        ``order`` is an optional triangle permutation (iterator order; it
        only affects depth-tie resolution). ``colors_override`` supplies
        (T, 3, 3) colours for untextured models. ``post`` and ``light`` as
        in ``render_arrays``.
        """
        tri_verts = model.vertices_by_triangles
        tri_norms = model.normals_by_triangles
        tri_colors = model.colors_by_triangles
        if tri_colors is None:
            tri_colors = colors_override
        if tri_colors is None:
            raise ValueError(
                "model has no texture colors; pass colors_override "
                "(the Renderer provides random/white fallback colors)")
        tri_colors = torch.as_tensor(tri_colors, dtype=torch.float32,
                                     device=self.device)
        if order is not None:
            order = order.to(device=self.device, dtype=torch.int64)
            tri_verts, tri_norms, tri_colors = (tri_verts[order],
                                                tri_norms[order],
                                                tri_colors[order])
        self.render_arrays(tri_verts, tri_norms, tri_colors, post=post,
                           light=light, keep_gbuffers=keep_gbuffers)

    def render_arrays(self, tri_verts: torch.Tensor, tri_norms: torch.Tensor,
                      tri_colors: torch.Tensor, post: str = "none", light=None,
                      keep_gbuffers: bool = False) -> None:
        """Render one frame from (T, 3, 3) triangle arrays on the filler's
        device.

        ``post``: ``"none"`` fills the G-buffer; ``"u8"`` / ``"lambert_u8"``
        (with ``light``, the pre-negated unit direction) produce the uint8
        image — read it with ``get_post_image()`` — and on a binned backend
        only it, unless ``keep_gbuffers`` asks for the G-buffer as well.
        """
        for t in (tri_verts, tri_norms, tri_colors):
            if t.device != self.device:
                raise ValueError(f"triangle arrays on {t.device}, filler on "
                                 f"{self.device}")
        if self.backend == "ratio":
            self._render_ratio(tri_verts, tri_norms, tri_colors, post, light)
            return
        if post == "lambert_u8" and self.fast_shade:
            post = "fast_lambert_u8"
        gbuffer = post == "none" or keep_gbuffers
        stats = {}
        gbuf, img, self.last_pairs = raster.render_frame(
            tri_verts, tri_norms, tri_colors, self.config, post=post,
            light=light, gbuffer=gbuffer, backend=self.backend, stats=stats)
        self._active_tiles = stats["active_tiles"]
        self._post_image = img
        self._gbuf = gbuf
        self._deferred = (None if gbuffer
                          else (tri_verts, tri_norms, tri_colors, post, light))

    def _render_ratio(self, tri_verts, tri_norms, tri_colors, post: str,
                      light) -> None:
        """A ratio frame (JAX ``fillers.py:419-445``): geometry, the bbox
        bucket (one host read), then ``raster_ref.rasterize``; the post
        image derives from the G-buffers."""
        degenerate, backfacing = visibility_masks(tri_verts, tri_norms)
        active = ~degenerate & ~backfacing
        tris_screen = project_to_screen(tri_verts, self.config)
        bbox = raster_ref.required_bbox_size(tris_screen, active, self.config)
        check_fragment_budget(bbox, self.device)
        self._gbuf = raster_ref.rasterize(tris_screen, tri_colors, tri_norms,
                                          active, self.config, bbox_size=bbox,
                                          chunk=ratio_chunk(bbox))
        self._deferred = None
        self.last_pairs, self._active_tiles = 0, None
        self._post_image = None
        if post != "none":
            color, _z, normal = self._gbuf
            self._post_image = cast_u8(lambert_shade(color, normal, light)
                                       if post == "lambert_u8" else color)

    def _rasterize(self, tri_verts, tri_norms, tri_colors, post: str = "none",
                   light=None):
        """Render one frame and return its (color, z, normal) G-buffers
        (JAX ``fillers.py:320-330``)."""
        self.render_arrays(tri_verts, tri_norms, tri_colors, post=post,
                           light=light)
        self._materialize()
        return self._gbuf

    def _materialize(self) -> None:
        """Derive the G-buffer of a post-only frame by re-rendering it in
        its own post mode (a fast-shade frame's G-buffer is its own)."""
        if self._gbuf is None:
            tv, tn, tc, post, light = self._deferred
            self._gbuf, _img, _n = raster.render_frame(
                tv, tn, tc, self.config, post=post, light=light, gbuffer=True,
                backend=self.backend)
            self._deferred = None

    def get_post_image(self) -> Optional[torch.Tensor]:
        """The (H, W, 3) uint8 image of the last frame, or None when it was
        rendered with ``post="none"``."""
        return self._post_image

    def get_render_stats(self) -> dict:
        """Stats of the last frame (JAX ``fillers.py:631-646``): ``pairs``,
        the frame's (triangle, tile) pair total — the port's exact demand,
        not JAX's slot bucket — and ``active_tiles``, its nonempty tiles
        (one host read); both None on the ``"ratio"`` backend, as on JAX's
        jnp path. ``pair_capacity`` and ``live_group_capacity`` are None:
        the JAX package's slot buckets have no counterpart (B4's capacity
        is internal, and a frame past it ran again before it returned)."""
        binned = self._active_tiles is not None
        return {"pairs": self.last_pairs if binned else None,
                "active_tiles": int(self._active_tiles) if binned else None,
                "pair_capacity": None, "live_group_capacity": None}

    def validate_capacity(self) -> bool:
        """True: a frame past B4's capacity ran again before it returned,
        so no frame's bins overflow."""
        return True

    @property
    def frame_provisional(self) -> bool:
        """False: every frame is complete when ``render`` returns."""
        return False

    def snapshot_buffers(self, strict: bool = False):
        """The last frame's (color, z, normals, post_image); ``strict`` is
        accepted for API parity — frames are always complete."""
        del strict
        self._materialize()
        return (*self._gbuf, self._post_image)

    # buffer getters, cy-reference naming (pyx:246-253)
    def get_color_buffer(self) -> torch.Tensor:
        self._materialize()
        return self._gbuf[0]

    def get_z_buffer(self) -> torch.Tensor:
        self._materialize()
        return self._gbuf[1]

    def get_normals_buffer(self) -> torch.Tensor:
        self._materialize()
        return self._gbuf[2]

    def reset_buffers(self) -> None:
        h, w = self.get_size()
        self._gbuf = raster.background(h, w, self.config.z_init, self.device)
        self._deferred = None
        self._post_image = None

    # ------------------------------------------------------------------
    # per-triangle compat path (py reference semantics)
    # ------------------------------------------------------------------

    def compute_triangle_statistics(self, triangle, colors, normals,
                                    color_buffer, z_buffer, n_buffer):
        """Rasterize one triangle into caller-owned ``Buffer``s, in place.

        Matches ``py/pixel_buffer_filler/advanced_pixel_buffer_filler.py:
        39-82`` including its culling rules (JAX ``fillers.py:743-784``).
        The buffers must be on the filler's device. The prelude (cull,
        project, ceil bbox) runs where the triangle lives: from host arrays,
        as the Renderer's iterator yields them, it launches nothing; from
        card tensors it ends in one host read of its verdict and bbox. Only
        the window around the clipped ceil bbox is then evaluated, on the
        filler's device.
        """
        assert color_buffer.get_size() == z_buffer.get_size() \
            == n_buffer.get_size() == self.get_size(), (
            "Buffers' spatial dimensions must be the same, but received: "
            f"color_buffer - {color_buffer.get_size()}, "
            f"z_buffer - {z_buffer.get_size()}, "
            f"n_buffer - {n_buffer.get_size()}.")
        for buf in (color_buffer, z_buffer, n_buffer):
            if buf.device != self.device:
                raise ValueError(f"buffer on {buf.device}, filler on "
                                 f"{self.device}")

        tri, cols, norms = (torch.as_tensor(x, dtype=torch.float32)
                            for x in (triangle, colors, normals))
        # culled or off-screen triangles touch nothing (py filler:59-68)
        ts, active, box = _compat_prelude(tri[None], norms[None], self.config)
        act, xl, xr, yl, yr = torch.cat([active.to(torch.int32)[None],
                                         box]).tolist()
        if not act or xr <= xl or yr <= yl:
            return
        h, w = self.get_size()
        # a power-of-two window over the clipped ceil bbox (py filler:
        # 108-145), its origin clamped so it stays inside the image
        bh = _pow2_bucket(yr - yl, h)
        bw = _pow2_bucket(xr - xl, w)
        y0, x0 = min(yl, h - bh), min(xl, w - bw)
        ts, cols, norms = (x.to(self.device) for x in (ts, cols, norms))
        _raster_one_window(ts, cols, norms, color_buffer.array, z_buffer.array,
                           n_buffer.array, y0, x0, (xl, xr, yl, yr), bh, bw)


class EdgeOnlyPixelBufferFiller(PixelBufferFiller):
    """Wireframe filler — draws triangle edges (or vertices only).

    API of the reference (``edge_only/edge_only_pixel_buffer_filler.py:
    8-33``; JAX ``fillers.py:787-865``): vertex coordinates are truncated to
    ints and drawn *without* projection (the reference uses it with
    ``normalize_model=True``). ``fill_all`` draws every edge at once with
    ``wireframe.rasterize_lines`` on the tensors' device.
    """

    def __init__(self, line_drawer, line_color, draw_edges: bool = True,
                 force_triangle_colors: bool = False):
        self.line_drawer = line_drawer
        self.line_color = np.asarray(line_color)
        self.draw_edges = draw_edges
        self.force_triangle_colors = force_triangle_colors

    def _color(self, colors, k):
        return colors[k] if self.force_triangle_colors else self.line_color

    def compute_triangle_statistics(self, triangle, colors, normals,
                                    color_buffer, z_buffer, n_buffer):
        p = [[int(triangle[k][0]), int(triangle[k][1])] for k in range(3)]
        if self.draw_edges:
            for k in range(3):
                self.line_drawer.draw_line(p[k], p[(k + 1) % 3], color_buffer,
                                           self._color(colors, k))
        else:
            for k in range(3):
                color_buffer.set_pixel(*p[k], self._color(colors, k))

    def fill_all(self, tri_verts: torch.Tensor, tri_colors: torch.Tensor,
                 color_arr: torch.Tensor) -> torch.Tensor:
        """Every triangle's edges (or vertices) drawn over ``color_arr``
        (H, W, C); returns the new image."""
        h, w = color_arr.shape[0], color_arr.shape[1]
        t = tri_verts.shape[0]
        pts = wireframe.to_i32(tri_verts[..., :2])      # truncation, ref:20-22
        if self.force_triangle_colors:
            line_colors = tri_colors.reshape(t * 3, -1)
        else:
            line = torch.as_tensor(self.line_color.astype(np.float32),
                                   device=color_arr.device).reshape(-1)
            line_colors = line.expand(t * 3, line.numel())
        active = torch.ones((t * 3,), dtype=torch.bool, device=color_arr.device)
        if self.draw_edges:
            starts, ends = wireframe.triangle_edges(pts)
            # lines are clipped to the viewport before stepping, so the
            # steps cover the <= max(h, w) + 1 on-screen pixels of any line
            return wireframe.rasterize_lines(color_arr, starts, ends,
                                             line_colors, active, h, w,
                                             2 * max(h, w))
        pts = pts.reshape(t * 3, 2)                     # zero-length "lines"
        return wireframe.rasterize_lines(color_arr, pts, pts, line_colors,
                                         active, h, w, 1)


def _pow2_bucket(need: int, cap: int) -> int:
    """Smallest power of two ≥ ``need`` (at least 8), clipped to ``cap``."""
    b = 8
    while b < need:
        b *= 2
    return min(b, cap)


def _compat_prelude(tri, norms, config: RenderConfig):
    """Cull + project + ceil bbox of one (1, 3, 3) triangle: (screen
    (3, 3), active, (xl, xr, yl, yr) int32) on its device."""
    degenerate, backfacing = visibility_masks(tri, norms)
    ts = project_to_screen(tri, config)
    box = torch.stack(raster_ref.bbox_ceil(ts[..., :2], config.width,
                                           config.height), dim=1)[0]
    return ts[0], (~degenerate & ~backfacing)[0], box


def _raster_one_window(ts, cols, norms, color_arr, z_arr, n_arr, y0: int,
                       x0: int, box, bh: int, bw: int) -> None:
    """One triangle over the (bh, bw) window at (y0, x0), written into the
    arrays in place (JAX ``fillers.py:887-925``): the batched oracle's
    λ / z / strict-< rules at absolute pixel coordinates, so the pixels
    equal a full-image evaluation's."""
    xl, xr, yl, yr = box
    win_c = color_arr[y0:y0 + bh, x0:x0 + bw]
    win_z = z_arr[y0:y0 + bh, x0:x0 + bw]
    win_n = n_arr[y0:y0 + bh, x0:x0 + bw]
    dev = ts.device
    px = x0 + torch.arange(bw, dtype=torch.int32, device=dev)[None, :]
    py = y0 + torch.arange(bh, dtype=torch.int32, device=dev)[:, None]
    in_bbox = (px >= xl) & (px < xr) & (py >= yl) & (py < yr)
    l0, l1, l2 = raster_ref.barycentric(ts[None, None, :, :2],
                                        px.to(torch.float32),
                                        py.to(torch.float32))
    inside = (l0 >= 0) & (l1 >= 0) & (l2 >= 0)
    z = (l0 * ts[0, 2] + l1 * ts[1, 2]) + l2 * ts[2, 2]
    win = (in_bbox & inside & (z >= 0.0) & (z <= 1.0)
           & (z < win_z[..., 0]))[..., None]
    win_c.copy_(torch.where(win, raster_ref.interp3(l0, l1, l2, cols),
                            win_c.to(torch.float32)))
    win_z.copy_(torch.where(win, z[..., None], win_z))
    win_n.copy_(torch.where(win, raster_ref.interp3(l0, l1, l2, norms),
                            win_n))
