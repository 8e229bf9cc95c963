"""Host time in the raster stage, µs a frame: the program's ``raster``
span around ``raster_tiles`` (B1's output allocation and launch). Moves
frame_ms."""
import program_spans


def read(trace):
    return program_spans.host_us(trace, "raster")
