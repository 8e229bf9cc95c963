"""The binning kernels of ``csrc/radix_sort.cu`` (B2's sort of the pair
keys on the sort route, B4's expansion, scan and sort on the counting
route): their bound over their device time, in percent. The bound
(``reference/bounds.py::binning``) takes the route and the pairs from the
reference's own bins. The sort route's PyTorch glue is not in it; it
shows in launch_calls. Moves view_ms."""
KERNELS = ("sort_coop_kernel", "upsweep_kernel", "scatter_kernel",
           "expand_kernel", "scan_kernel")
UNIT = "view"


def read(trace):
    return trace.roofline("binning", KERNELS) if trace.unit == UNIT else None
