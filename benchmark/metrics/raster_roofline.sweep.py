"""B1 (``csrc/raster.cu`` ``raster_kernel``, via
``ops/raster.py::raster_tiles``): its bound over its device time, in
percent. The bound (``reference/bounds.py::raster``: 28 instructions a
pixel of each binned pair's window) is counted from the reference's own
bins. Moves view_ms."""
KERNELS = ("raster_kernel",)
UNIT = "view"


def read(trace):
    return trace.roofline("raster", KERNELS) if trace.unit == UNIT else None
