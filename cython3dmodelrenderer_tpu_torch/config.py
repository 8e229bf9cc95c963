"""Render configuration.

The counterpart of ``cython3dmodelrenderer_tpu/config.py``: the reference
filler's constructor arguments (``h, w, fov=90, z_near=0.1, z_far=1000``)
bundled into a frozen dataclass, plus the backend choice.
"""
from __future__ import annotations

import dataclasses

BACKENDS = ("auto", "cuda", "torch", "ratio")


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static per-frame render parameters.

    ``height``/``width`` are the target image size, ``fov`` the vertical
    field of view in degrees, ``z_near``/``z_far`` the clip range mapped to
    depth [0, 1]. ``backend``: ``"cuda"`` runs the hand-written kernels
    (tensors must live on a CUDA device), ``"torch"`` runs their plain
    PyTorch versions on any device, ``"ratio"`` runs the ratio-form
    rasterizer (``ops/raster_ref.py``, the JAX ``"jnp"`` backend) on any
    device, and ``"auto"`` picks ``"cuda"`` for CUDA tensors and ``"torch"``
    otherwise (never ``"ratio"``).
    """

    height: int = 512
    width: int = 512
    fov: float = 90.0
    z_near: float = 0.1
    z_far: float = 1000.0
    #: depth buffer clear value (reference ``py/renderer.py:20`` uses 1e6)
    z_init: float = 1e6
    backend: str = "auto"

    @property
    def aspect(self) -> float:
        return self.height / self.width

    def __post_init__(self):
        if self.height <= 0 or self.width <= 0:
            raise ValueError("image dimensions must be positive")
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}")
