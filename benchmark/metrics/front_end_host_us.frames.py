"""Host time in the front end, µs a frame: the program's ``front_end``
span around F1's wrapper in ``render_frame`` (the host preparation and
F1's launch). Moves frame_ms."""
import program_spans


def read(trace):
    return program_spans.host_us(trace, "front_end")
