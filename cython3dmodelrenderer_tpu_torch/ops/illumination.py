"""Lambert ("Guro") illumination and the uint8 cast.

Counterpart of ``cython3dmodelrenderer_tpu/ops/illumination.py``. Reference
semantics (``crender/{py,cy}/illumination/guro_illumination.py``): the
stored direction is the negated, normalized light direction; per pixel
``shadow = clip(dot(n, light) / (‖n‖ + 1e-6), 0, 1)`` scales the colour.

``lambert_shade`` evaluates in the raster kernel's own operation order
(``raster_pallas.py:642-651``): ``dot = nx*lx + ny*ly + nz*lz`` and
``sqrt(nx*nx + ny*ny + nz*nz)`` left to right, so the plain path, the
kernel and the JAX kernel round alike. The dot starts from +0.0 as XLA's
``jnp.sum`` does, so a dot of -0.0 products reads +0.0 (the background of
an f32 Lambert sweep); the u8 image, and so the kernel, never see the sign
of a zero.
"""
from __future__ import annotations

from abc import abstractmethod

import numpy as np
import torch


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root, as XLA's and the kernels'
    (``__fsqrt_rn``). PyTorch's CPU ``sqrt`` runs through MKL's vector
    math: accurate to one ulp only, and on a process's first large
    multi-threaded call to fewer bits still, so on the CPU NumPy's (the
    IEEE instruction) takes its place; CUDA's ``sqrt`` rounds correctly."""
    if x.device.type != "cpu":
        return torch.sqrt(x)
    return torch.from_numpy(np.sqrt(x.contiguous().numpy()))


def lambert_shade(color: torch.Tensor, n_buffer: torch.Tensor,
                  light) -> torch.Tensor:
    """``color * clip(dot(n, l) / (‖n‖ + 1e-6), 0, 1)`` over the last axis.

    ``light`` is the pre-negated, normalized direction (3 floats).
    """
    lx, ly, lz = (float(v) for v in light)
    nx, ny, nz = n_buffer[..., 0], n_buffer[..., 1], n_buffer[..., 2]
    dot = ((nx * lx + 0.0) + ny * ly) + nz * lz
    norm = sqrt_rn((nx * nx + ny * ny) + nz * nz)
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
    op; ``draw_illumination`` the reference's wrapper over ``Buffer``
    objects (``illumination/illumination_drawer.py:5-13``)."""

    @abstractmethod
    def apply(self, color: torch.Tensor, n_buffer: torch.Tensor) -> torch.Tensor:
        ...

    def draw_illumination(self, color_buffer, n_buffer):
        """Shade a colour ``Buffer`` in place by ``n_buffer`` (py reference
        form), or, given raw arrays, return the shaded float32 array (cy
        reference form)."""
        from ..models.buffer import Buffer

        if isinstance(color_buffer, Buffer):
            color_buffer.array = self.apply(
                color_buffer.array.to(torch.float32), n_buffer.array)
            return None
        return self.apply(torch.as_tensor(color_buffer, dtype=torch.float32),
                          torch.as_tensor(n_buffer))


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
