"""cython3dmodelrenderer_tpu_torch — the rasterizer on PyTorch and CUDA.

A port of ``cython3dmodelrenderer_tpu`` (JAX on a TPU, kept as the
reference) to PyTorch with hand-written Hopper kernels. Imports torch and
numpy only; the CUDA kernels build from ``csrc/`` on first launch.
"""
from .config import RenderConfig
from .fillers import AdvancedPixelBufferFiller, PixelBufferFiller
from .models.buffer import Buffer
from .models.iterators import DepthIterator, SimpleIterator, TriangleIterator
from .models.model import Model, fit_model
from .ops.illumination import (GuroIllumination, IlluminationDrawer,
                               NoIllumination)
from .renderer import Renderer

__all__ = [
    "AdvancedPixelBufferFiller", "Buffer", "DepthIterator", "GuroIllumination",
    "IlluminationDrawer", "Model", "NoIllumination", "PixelBufferFiller",
    "RenderConfig", "Renderer", "SimpleIterator", "TriangleIterator",
    "fit_model",
]
