from .buffer import Buffer
from .iterators import DepthIterator, SimpleIterator, TriangleIterator
from .model import Model, fit_model

__all__ = ["Buffer", "DepthIterator", "Model", "SimpleIterator",
           "TriangleIterator", "fit_model"]
