"""Helpers: the sequential NumPy oracle renderer (``oracle``) and frame
timing and profiling (``timing``)."""
