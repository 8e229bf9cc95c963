"""Lambert ("Guro") illumination and the uint8 cast.

Counterpart of ``cython3dmodelrenderer_tpu/ops/illumination.py``. Reference
semantics (``crender/{py,cy}/illumination/guro_illumination.py``): the
stored direction is the negated, normalized light direction; per pixel
``shadow = clip(dot(n, light) / (‖n‖ + 1e-6), 0, 1)`` scales the colour.

``lambert_shade`` evaluates in the raster kernel's own operation order
(``raster_pallas.py:642-651``): ``dot = nx*lx + ny*ly + nz*lz`` and
``sqrt(nx*nx + ny*ny + nz*nz)`` left to right, so the plain path, the
kernel and the JAX kernel round alike.
"""
from __future__ import annotations

from abc import abstractmethod

import numpy as np
import torch


def lambert_shade(color: torch.Tensor, n_buffer: torch.Tensor,
                  light) -> torch.Tensor:
    """``color * clip(dot(n, l) / (‖n‖ + 1e-6), 0, 1)`` over the last axis.

    ``light`` is the pre-negated, normalized direction (3 floats).
    """
    lx, ly, lz = (float(v) for v in light)
    nx, ny, nz = n_buffer[..., 0], n_buffer[..., 1], n_buffer[..., 2]
    dot = (nx * lx + ny * ly) + nz * lz
    norm = torch.sqrt((nx * nx + ny * ny) + nz * nz)
    shadow = dot / (norm + 1e-6)
    # comparisons keep a NaN shadow NaN, as jnp.clip does
    shadow = torch.where(shadow < 0.0, 0.0, shadow)
    shadow = torch.where(shadow > 1.0, 1.0, shadow)
    return color * shadow[..., None]


def cast_u8(color: torch.Tensor) -> torch.Tensor:
    """float → uint8 by int32 truncation then ``& 255`` (no saturation)."""
    return (color.to(torch.int32) & 255).to(torch.uint8)


class IlluminationDrawer:
    """Shading pass over (color, normal) G-buffers: ``apply`` is the tensor
    op. (The reference's ``draw_illumination`` over ``Buffer`` objects
    serves the per-triangle path, ROADMAP queue A item 6.)"""

    @abstractmethod
    def apply(self, color: torch.Tensor, n_buffer: torch.Tensor) -> torch.Tensor:
        ...


class NoIllumination(IlluminationDrawer):
    def apply(self, color: torch.Tensor, n_buffer: torch.Tensor) -> torch.Tensor:
        return color


class GuroIllumination(IlluminationDrawer):
    def __init__(self, light_direction=(0, 0, 1)):
        """Primitive Lambert illumination (reference guro_illumination.py:7-18).

        ``light_direction`` is the direction the light falls along; it is
        negated and normalized in float32 at construction
        (``illumination.py:86-87``).
        """
        light = -np.asarray(light_direction, dtype="float32")
        self.light_direction = light / np.linalg.norm(light)

    def apply(self, color: torch.Tensor, n_buffer: torch.Tensor) -> torch.Tensor:
        return lambert_shade(color, n_buffer, self.light_direction)
