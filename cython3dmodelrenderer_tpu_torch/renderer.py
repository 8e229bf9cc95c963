"""Render orchestration — the user-facing ``Renderer``.

Counterpart of ``cython3dmodelrenderer_tpu/renderer.py`` with the reference
API (``crender/py/renderer.py:9-66``): ``Renderer(filler, illumination,
iterator_type, image_height, image_width, use_tqdm)`` whose
``.render(model, normalize_model, random_colors)`` returns the colour
``Buffer``, plus ``.reset_buffers()``.

The filler's type picks the path, as in JAX (``renderer.py:75-80``):

* ``AdvancedPixelBufferFiller`` — the batched frame. With
  ``GuroIllumination`` it is the ``"lambert_u8"`` post, with
  ``NoIllumination`` the ``"u8"`` post; the z and normal buffers are lazy
  and re-render with G-buffer output on first access. Any other drawer
  gets the frame's G-buffers (``snapshot_buffers``) and the colour buffer
  is ``cast_u8(drawer.apply(color, normals))``.
* ``EdgeOnlyPixelBufferFiller`` — the batched wireframe (``fill_all``);
  a line drawer that is not exactly ``LineBresenham`` must see every edge,
  so it takes the per-triangle loop.
* any other filler — the reference's per-triangle loop
  (``compute_triangle_statistics`` into the Renderer's buffers), then
  ``draw_illumination``.

Untextured models get per-triangle colours from the renderer's
``torch.Generator``: the stream of ``torch.randint(256, (T, 3))``, drawn
by ``native/mt_draw.cpp`` where it can into pinned memory, which
``csrc/colors.cu`` reads from the card without a synchronisation (a
``"torch"`` or ``"ratio"`` filler copies them and expands them in
PyTorch). ``render_sequence`` renders a pose sequence through the multi-view sweep
(``parallel.multiview``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .device import resolve_device
from .fillers import (AdvancedPixelBufferFiller, EdgeOnlyPixelBufferFiller,
                      PixelBufferFiller)
from .models.buffer import Buffer
from .models.model import Model
from .native import mt_draw_native
from .ops.colors import vertex_colors, vertex_colors_plain
from .ops.illumination import (GuroIllumination, IlluminationDrawer,
                               NoIllumination, cast_u8)
from .ops.wireframe import LineBresenham
from .utils import timing


class Renderer:
    def __init__(self, pixel_buffer_filler: PixelBufferFiller,
                 illumination: IlluminationDrawer,
                 triangle_iterator_type: type,
                 image_height: int = 512, image_width: int = 512,
                 use_tqdm: bool = True, device=None,
                 generator: Optional[torch.Generator] = None):
        """``device`` defaults to the filler's; ``generator`` (a CPU
        ``torch.Generator``) draws the fallback colours of untextured
        models — a fresh default-seeded one when omitted. ``use_tqdm`` is
        accepted for API compatibility and ignored (no progress bar)."""
        del use_tqdm
        self.pixel_buffer_filler = pixel_buffer_filler
        self.illumination = illumination
        self.triangle_iterator_type = triangle_iterator_type
        self.im_h = image_height
        self.im_w = image_width
        if device is None:
            device = getattr(pixel_buffer_filler, "device", None)
        self.device = resolve_device(device)
        self.generator = generator if generator is not None else torch.Generator()
        self._staging: Optional[_PinnedColors] = None
        self.color_buffer = Buffer(image_height, image_width, dim=3,
                                   dtype="uint8", device=self.device)
        self.z_buffer = Buffer(image_height, image_width, dim=1, init_val=1e6,
                               dtype="float32", device=self.device)
        self.n_buffer = Buffer(image_height, image_width, dim=3,
                               dtype="float32", device=self.device)

    def render(self, model: Model, normalize_model: bool = False,
               random_colors: bool = True) -> Buffer:
        """Render the model; returns the colour buffer.

        ``normalize_model`` applies the reference's fit
        (``py/renderer.py:44-49``) by mutating the model. ``random_colors``
        picks a random (else white) colour per triangle for untextured
        models (``py/renderer.py:53-55``).
        """
        with timing.span("render"):
            if normalize_model:
                image_center = (self.im_h // 2, self.im_w // 2)
                image_span = min(image_center)
                model.scale(image_span / model.get_max_span())
                model.shift(-model.get_mean_vertex()
                            + np.array([image_center[0], image_center[1],
                                        -image_span], dtype=np.float32))
            colors_override = self._fallback_colors(model, random_colors)
            if isinstance(self.pixel_buffer_filler, AdvancedPixelBufferFiller):
                self._render_batched(model, colors_override)
            elif isinstance(self.pixel_buffer_filler,
                            EdgeOnlyPixelBufferFiller):
                self._render_wireframe(model, colors_override)
            else:
                self._render_per_triangle(model, colors_override)
        return self.color_buffer

    def _fallback_colors(self, model: Model,
                         random_colors: bool) -> Optional[torch.Tensor]:
        """(T, 3, 3) float32 colours for untextured models, else None: the
        next ``torch.randint(256, (T, 3))`` of the renderer's generator
        (else white), one colour for the three vertices of each triangle.
        The draw and its way to the device run in the span
        ``fallback_colors``; a textured model enters no span."""
        if model.has_colors:
            return None
        with timing.span("fallback_colors"):
            t = model.n_triangles()
            if not random_colors:
                return torch.full((t, 3, 3), 255.0, dtype=torch.float32,
                                  device=self.device)
            # the filler's backend picks kernel or plain, as
            # raster.stage_functions does; a filler without one (the
            # per-triangle loop, the wireframe) takes the card's kernel
            backend = getattr(self.pixel_buffer_filler, "backend", "cuda")
            if self.device.type == "cuda" and backend == "cuda":
                if self._staging is None or self._staging.t != t:
                    self._staging = _PinnedColors(t)
                return self._staging.send(self._draw_into, self.device)
            host = torch.empty((t, 3), dtype=torch.uint8)
            self._draw_into(host)
            return vertex_colors_plain(host.to(self.device))

    def _draw_into(self, host: torch.Tensor) -> None:
        """Fill the uint8 CPU tensor ``host`` as ``torch.randint(256,
        host.shape)`` from the renderer's generator: natively where the
        generator's state is the layout ``native/mt_draw.cpp`` reads, else
        with ``torch.randint``; the counters say which."""
        if mt_draw_native.draw_u8(self.generator, host):
            timing.counters["fallback_draws_native"] += 1
        else:
            torch.randint(256, host.shape, generator=self.generator,
                          out=host)
            timing.counters["fallback_draws_torch"] += 1

    def _order(self, model: Model) -> Optional[torch.Tensor]:
        cls = self.triangle_iterator_type
        if cls is None or cls.__name__ == "SimpleIterator":
            return None                      # identity order: no gather
        try:
            return cls.order_indices(model)
        except (AttributeError, NotImplementedError):
            return None                      # no order of its own: model order

    def _render_batched(self, model: Model,
                        colors_override: Optional[torch.Tensor]) -> None:
        filler = self.pixel_buffer_filler
        # exact types: a subclass may override apply()
        if type(self.illumination) is GuroIllumination:
            post, light = "lambert_u8", self.illumination.light_direction
        elif type(self.illumination) is NoIllumination:
            post, light = "u8", None
        else:
            # a custom drawer shades the frame's G-buffers (JAX
            # renderer.py:124-142)
            filler.render_model(model, order=self._order(model),
                                colors_override=colors_override,
                                post="none", keep_gbuffers=True)
            color, z, normals, _img = filler.snapshot_buffers()
            self.color_buffer.array = cast_u8(self.illumination.apply(color,
                                                                      normals))
            self.z_buffer.array = z
            self.n_buffer.array = normals
            return
        filler.render_model(model, order=self._order(model),
                            colors_override=colors_override,
                            post=post, light=light)
        self.color_buffer.array = filler.get_post_image()
        self.z_buffer.set_lazy(filler.get_z_buffer)
        self.n_buffer.set_lazy(filler.get_normals_buffer)

    def _render_wireframe(self, model: Model,
                          colors_override: Optional[torch.Tensor]) -> None:
        """JAX ``renderer.py:157-176``: the batched wireframe over the
        colour buffer, then the drawer's ``apply``."""
        filler = self.pixel_buffer_filler
        drawer = getattr(filler, "line_drawer", None)
        if drawer is not None and type(drawer) is not LineBresenham:
            self._render_per_triangle(model, colors_override)
            return
        tri_colors = model.colors_by_triangles
        if tri_colors is None:
            tri_colors = colors_override
        color = filler.fill_all(model.vertices_by_triangles,
                                tri_colors.to(torch.float32),
                                self.color_buffer.array.to(torch.float32))
        self.color_buffer.array = self.illumination.apply(color,
                                                          self.n_buffer.array)

    def _render_per_triangle(self, model: Model,
                             colors_override: Optional[torch.Tensor]) -> None:
        """The reference's per-triangle loop (``py/renderer.py:51-58``)."""
        override = (colors_override.cpu().numpy()
                    if colors_override is not None else None)
        for i, (triangle, colors, normals) in enumerate(
                self.triangle_iterator_type(model)):
            if colors is None:
                colors = override[i]
            self.pixel_buffer_filler.compute_triangle_statistics(
                triangle, colors, normals,
                self.color_buffer, self.z_buffer, self.n_buffer)
        self.illumination.draw_illumination(self.color_buffer, self.n_buffer)

    def render_sequence(self, model: Model, angles, shifts=None,
                        random_colors: bool = True, view_batch: int = 1,
                        fast_shade: bool = False) -> torch.Tensor:
        """Render a pose sequence; returns display-ready (N, H, W, 3)
        uint8 frames (JAX ``renderer.py:193-244``).

        Frame i rotates the model as it stands by ``angles[i]`` (Euler XYZ
        degrees) and translates it by ``shifts[i]`` (default ``[0, 0, 1]``)
        through ``parallel.multiview.render_sequence_pallas``, which sizes
        each batch of ``view_batch`` views exactly. The light comes from
        this Renderer's drawer (NoIllumination: none); fallback colours of
        an untextured model from its generator. The Renderer's own buffers
        are not touched. Needs an ``AdvancedPixelBufferFiller``.
        """
        from .parallel import multiview

        with timing.span("sequence"):
            filler = self.pixel_buffer_filler
            if not isinstance(filler, AdvancedPixelBufferFiller):
                raise TypeError(
                    "render_sequence needs AdvancedPixelBufferFiller")
            if type(self.illumination) is NoIllumination:
                light_direction = None
            elif type(self.illumination) is GuroIllumination:
                # the sweep negates and normalises again: hand it the raw
                # direction recovered from the drawer's pre-negated unit
                # vector
                light_direction = -np.asarray(
                    self.illumination.light_direction, np.float32)
            else:
                raise TypeError("render_sequence supports GuroIllumination "
                                "/ NoIllumination (custom drawers: render "
                                "frames individually)")
            tri_colors = model.colors_by_triangles
            if tri_colors is None:
                tri_colors = self._fallback_colors(model, random_colors)
            tv, tn = model.vertices_by_triangles, model.normals_by_triangles
            for t in (tv, tn, tri_colors):
                if t.device != filler.device:
                    raise ValueError(f"model arrays on {t.device}, filler on "
                                     f"{filler.device}")
            angles = np.asarray(angles, np.float32).reshape(-1, 3)
            if shifts is None:
                shifts = np.broadcast_to(np.float32([0.0, 0.0, 1.0]),
                                         angles.shape)
            return multiview.render_sequence_pallas(
                tv, tn, tri_colors, angles, shifts, filler.config, post="u8",
                view_batch=view_batch, fast_shade=fast_shade,
                light_direction=light_direction, backend=filler.backend)

    def reset_buffers(self) -> None:
        self.n_buffer.clear()
        self.z_buffer.clear()
        self.color_buffer.clear()
        if isinstance(self.pixel_buffer_filler, AdvancedPixelBufferFiller):
            self.pixel_buffer_filler.reset_buffers()


class _PinnedColors:
    """A pinned (t, 3) uint8 host buffer for the fallback colours, and an
    event recorded after the last launch that read it
    (``ops/colors.py::vertex_colors``, straight from the host). A draw
    rewrites the buffer only once that event has passed, and waits for it
    otherwise. Every render path reads from the device after the launch
    (the pair total, the wireframe's line length, the per-triangle path's
    copy to the host), so frames never wait here, and no launch is queued
    when a renderer drops the buffer for another T."""

    def __init__(self, t: int):
        self.t = t
        self.buffer = torch.empty((t, 3), dtype=torch.uint8, pin_memory=True)
        self.event = torch.cuda.Event()

    def send(self, draw, device: torch.device) -> torch.Tensor:
        """``draw`` into the buffer once its last launch has run, then
        expand it on ``device``'s current stream without a
        synchronisation; returns the (t, 3, 3) float32 colours."""
        if not self.event.query():
            self.event.synchronize()
        draw(self.buffer)
        stream = torch.cuda.current_stream(device)
        colors = vertex_colors(self.buffer, device, stream)
        self.event.record(stream)
        return colors
