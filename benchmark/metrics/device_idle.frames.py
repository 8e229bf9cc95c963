"""The share of the traced window in which no operation ran on the
device, in percent: one minus the union of the device operations'
intervals over the window. Moves frame_ms: an idle device waits for the
host."""
UNIT = "frame"


def read(trace):
    if trace.unit != UNIT or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
