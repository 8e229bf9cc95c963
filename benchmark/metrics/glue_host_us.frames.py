"""Frame glue on the host, µs a frame: the self time of the program's
``render`` span (``Renderer.render``), its duration less its child spans.
What is left is the frame's host work outside F1, the pair-total read,
binning and B1: fallback colours, the colour and order gathers,
``as_tensor``, the active-tiles statistic, the ``Buffer`` wrapping.
Moves frame_ms."""
import program_spans


def read(trace):
    return program_spans.self_us(trace, "render")
