"""Render orchestration — the user-facing ``Renderer``.

Counterpart of ``cython3dmodelrenderer_tpu/renderer.py`` with the reference
API (``crender/py/renderer.py:9-66``): ``Renderer(filler, illumination,
iterator_type, image_height, image_width, use_tqdm)`` whose
``.render(model, normalize_model, random_colors)`` returns the colour
``Buffer``, plus ``.reset_buffers()``.

The batched path only: with ``GuroIllumination`` a frame is the
``"lambert_u8"`` post, with ``NoIllumination`` the ``"u8"`` post, shaded and
quantized inside the raster kernel; the z and normal buffers are lazy and
re-render with G-buffer output on first access. Untextured models get
per-triangle colours from the renderer's ``torch.Generator``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .device import resolve_device
from .fillers import AdvancedPixelBufferFiller, PixelBufferFiller
from .models.buffer import Buffer
from .models.model import Model
from .ops.illumination import GuroIllumination, IlluminationDrawer, NoIllumination


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
        accepted for API compatibility; the batched path has no loop."""
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
        if not isinstance(self.pixel_buffer_filler, AdvancedPixelBufferFiller):
            raise NotImplementedError(
                "only AdvancedPixelBufferFiller is ported: wireframe is ROADMAP "
                "queue A item 10, custom per-triangle fillers item 6")
        if normalize_model:
            image_center = (self.im_h // 2, self.im_w // 2)
            image_span = min(image_center)
            model.scale(image_span / model.get_max_span())
            model.shift(-model.get_mean_vertex()
                        + np.array([image_center[0], image_center[1],
                                    -image_span], dtype=np.float32))
        self._render_batched(model, self._fallback_colors(model, random_colors))
        return self.color_buffer

    def _fallback_colors(self, model: Model,
                         random_colors: bool) -> Optional[torch.Tensor]:
        """(T, 3, 3) colours for untextured models, else None."""
        if model.colors_by_triangles is not None:
            return None
        t = model.n_triangles()
        if random_colors:
            per_tri = torch.randint(256, (t, 3), generator=self.generator)
        else:
            per_tri = torch.full((t, 3), 255)
        per_tri = per_tri.to(device=self.device, dtype=torch.float32)
        return per_tri[:, None, :].expand(t, 3, 3).contiguous()

    def _order(self, model: Model) -> Optional[torch.Tensor]:
        cls = self.triangle_iterator_type
        if cls is None or cls.__name__ == "SimpleIterator":
            return None                      # identity order: no gather
        return cls.order_indices(model)

    def _render_batched(self, model: Model,
                        colors_override: Optional[torch.Tensor]) -> None:
        if type(self.illumination) is GuroIllumination:
            post, light = "lambert_u8", self.illumination.light_direction
        elif type(self.illumination) is NoIllumination:
            post, light = "u8", None
        else:
            raise NotImplementedError(
                "custom illumination drawers (the eager G-buffer path) are "
                "ROADMAP queue A item 6")
        filler = self.pixel_buffer_filler
        filler.render_model(model, order=self._order(model),
                            colors_override=colors_override,
                            post=post, light=light)
        self.color_buffer.array = filler.get_post_image()
        self.z_buffer.set_lazy(filler.get_z_buffer)
        self.n_buffer.set_lazy(filler.get_normals_buffer)

    def render_sequence(self, *args, **kwargs):
        raise NotImplementedError("pose sequences are ROADMAP queue A item 11")

    def reset_buffers(self) -> None:
        self.n_buffer.clear()
        self.z_buffer.clear()
        self.color_buffer.clear()
        if isinstance(self.pixel_buffer_filler, AdvancedPixelBufferFiller):
            self.pixel_buffer_filler.reset_buffers()
