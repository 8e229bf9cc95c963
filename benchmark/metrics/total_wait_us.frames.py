"""The frame's one host read, µs a frame: the program's ``pair_total``
span around ``int(total)`` in ``render_frame``, where the host waits for
F1 to finish and for the copy of its pair total. Moves frame_ms."""
import program_spans


def read(trace):
    return program_spans.host_us(trace, "pair_total")
