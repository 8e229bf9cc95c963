"""The reference's pure-Python tree (``crender/py/``)."""
from ...renderer import Renderer
from . import data_structures, illumination, pixel_buffer_filler, \
    triangle_iterator

__all__ = ["Renderer", "data_structures", "illumination",
           "pixel_buffer_filler", "triangle_iterator"]
