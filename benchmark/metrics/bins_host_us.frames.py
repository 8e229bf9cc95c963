"""Host time in binning, µs a frame: the program's ``bins`` span around
``route_bins`` (the sort route's PyTorch glue and B2, or B4). Moves
frame_ms."""
import program_spans


def read(trace):
    return program_spans.host_us(trace, "bins")
