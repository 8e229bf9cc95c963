"""Host calls that enqueue device work (kernel launches, memsets and
copies) in the traced window, a view. Moves view_ms: the host enqueues each
of them while the device waits."""
from tracing import LAUNCH_CALLS

UNIT = "view"


def read(trace):
    if trace.unit != UNIT or not trace.units:
        return None
    return trace.host_calls(LAUNCH_CALLS) / trace.units
