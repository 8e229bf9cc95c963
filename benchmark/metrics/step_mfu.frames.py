"""The whole step's share of the card's peak, in percent: the bounds of
F1, binning and B1 together (``reference/bounds.py``) over the time
a frame took in the run's untraced window. It bounds the kernels' shares:
a kernel taken off the path leaves its own roofline silent, not this.
Moves frame_ms."""
UNIT = "frame"


def read(trace):
    if trace.unit != UNIT or not trace.units or not trace.seconds_per_unit:
        return None
    bound = sum(trace.bounds.get(k, 0.0) for k in ("f1", "binning", "raster"))
    if not bound:
        return None
    return 100.0 * bound / trace.units / trace.seconds_per_unit
