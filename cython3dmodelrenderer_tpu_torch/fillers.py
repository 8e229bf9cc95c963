"""Pixel-buffer filler: the rasterizer behind the ``Renderer``.

Counterpart of ``AdvancedPixelBufferFiller`` in
``cython3dmodelrenderer_tpu/fillers.py:185-784`` — the z-buffered
whole-model rasterizer that owns its G-buffers (reference Version C,
``advanced_pixel_buffer_filler.pyx:92``).

Capacity: every frame sizes its bins exactly from its own pair total (one
host read per frame), so no bin can overflow. The JAX package's capacity
buckets, background demand reader and overflow re-render have no
counterpart, and ``validate_capacity`` is trivially true.

A post frame (``"u8"``/``"lambert_u8"``/``"fast_lambert_u8"``) writes only
the uint8 image. Its G-buffer getters re-render the retained inputs, in the
same post mode, with G-buffer output on first access — bit-identical, the
kernels are deterministic — as the JAX filler's ``_materialize`` does
(``fillers.py:452-486``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .config import RenderConfig
from .device import resolve_backend, resolve_device
from .ops import raster


class PixelBufferFiller:
    """Abstract per-triangle filler interface (reference
    ``pixel_buffer_filler.py:7-11``)."""

    def compute_triangle_statistics(self, triangle, colors, normals,
                                    color_buffer, z_buffer, n_buffer):
        raise NotImplementedError(
            "per-triangle rasterization is ROADMAP queue A item 6 "
            "(compute_triangle_statistics compat path)")


class AdvancedPixelBufferFiller(PixelBufferFiller):
    """Z-buffered triangle rasterizer with device G-buffers.

    Constructor signature of the reference filler (``py filler:14``) plus
    ``backend`` (``"auto" | "cuda" | "torch"``, see ``RenderConfig``) and
    ``device``; ``n_threads`` is accepted and ignored. ``fast_shade=True``
    (JAX ``fillers.py:197-208``) renders every ``"lambert_u8"`` frame as
    ``"fast_lambert_u8"``: Lambert baked per vertex (Gouraud), the
    z-buffer bit-equal to exact mode, the normal G-buffer zeros.
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
        # the JAX filler's lane-subgroup packing (fillers.py:251-253): frames
        # route their bins as its frames do (ops/raster.py::render_frame)
        self._group: int = raster.GROUP
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
        (with ``light``, the pre-negated unit direction) produce only the
        uint8 image — read it with ``get_post_image()`` — unless
        ``keep_gbuffers`` asks for the G-buffer as well.
        """
        for t in (tri_verts, tri_norms, tri_colors):
            if t.device != self.device:
                raise ValueError(f"triangle arrays on {t.device}, filler on "
                                 f"{self.device}")
        if post == "lambert_u8" and self.fast_shade:
            post = "fast_lambert_u8"
        gbuffer = post == "none" or keep_gbuffers
        gbuf, img, self.last_pairs = raster.render_frame(
            tri_verts, tri_norms, tri_colors, self.config, post=post,
            light=light, gbuffer=gbuffer, backend=self.backend,
            group=self._group)
        self._post_image = img
        self._gbuf = gbuf
        self._deferred = (None if gbuffer
                          else (tri_verts, tri_norms, tri_colors, post, light))

    def _materialize(self) -> None:
        """Derive the G-buffer of a post-only frame by re-rendering it in
        its own post mode (a fast-shade frame's G-buffer is its own)."""
        if self._gbuf is None:
            tv, tn, tc, post, light = self._deferred
            self._gbuf, _img, _n = raster.render_frame(
                tv, tn, tc, self.config, post=post, light=light, gbuffer=True,
                backend=self.backend, group=self._group)
            self._deferred = None

    def get_post_image(self) -> Optional[torch.Tensor]:
        """The (H, W, 3) uint8 image of the last frame, or None when it was
        rendered with ``post="none"``."""
        return self._post_image

    def validate_capacity(self) -> bool:
        """True: bins are sized exactly per frame, so no frame can overflow."""
        return True

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
