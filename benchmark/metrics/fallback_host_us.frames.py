"""Host time in the fallback colours, µs a frame: the program's
``fallback_colors`` span, around the draw of an untextured model's
colours from the renderer's generator and their copy to the device.
None where no span was entered (textured models, or a program without
the span). The span is a child of ``render``, so ``glue_host_us.frames``
does not count the draw where this reads a number. Moves frame_ms."""
import program_spans


def read(trace):
    return program_spans.host_us(trace, "fallback_colors")
