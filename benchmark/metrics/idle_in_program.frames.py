"""The share of the traced window's device-idle time during which the
host was inside one of the program's spans, in percent; the rest of the
idle time is the harness loop's (its synchronisation and its bookkeeping
between frames). Moves frame_ms."""
import program_spans


def read(trace):
    return program_spans.idle_in_program(trace)
