"""F1 (``csrc/frontend.cu`` ``frontend_kernel``, via
``ops/frontend.py::frame_planes``): its bound over its device time, in
percent. The bound (``reference/bounds.py::f1``) is counted from the
step's shapes. Moves view_ms."""
KERNELS = ("frontend_kernel",)
UNIT = "view"


def read(trace):
    return trace.roofline("f1", KERNELS) if trace.unit == UNIT else None
