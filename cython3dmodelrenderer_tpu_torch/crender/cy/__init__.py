"""The reference's compiled tree (``crender/cy/``).

Its ``Renderer.render`` returns the raw float colour array, which its
caller flips and casts (reference ``run.py:26``): here a host float32
(H, W, 3) NumPy array.
"""
import numpy as np
import torch

from ...fillers import AdvancedPixelBufferFiller
from ...renderer import Renderer as _Renderer
from . import data_structures, illumination, pixel_buffer_filler, \
    triangle_iterator


class Renderer(_Renderer):
    def render(self, model, normalize_model: bool = False,
               random_colors: bool = True) -> np.ndarray:
        super().render(model, normalize_model=normalize_model,
                       random_colors=random_colors)
        if isinstance(self.pixel_buffer_filler, AdvancedPixelBufferFiller):
            filler = self.pixel_buffer_filler
            shaded = self.illumination.apply(filler.get_color_buffer(),
                                             filler.get_normals_buffer())
            return shaded.cpu().numpy()
        return self.color_buffer.array.to(torch.float32).cpu().numpy()


__all__ = ["Renderer", "data_structures", "illumination",
           "pixel_buffer_filler", "triangle_iterator"]
