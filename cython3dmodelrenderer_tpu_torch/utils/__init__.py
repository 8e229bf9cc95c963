"""NumPy helpers: the sequential oracle renderer (``oracle``)."""
