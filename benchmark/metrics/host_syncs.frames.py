"""Synchronisations with the device inside ``Renderer.render`` (stream,
device and event synchronisations and blocking copies), a frame: today
the read of F1's pair total. The harness's own synchronisation at the end
of a frame lies outside the range and is not counted. Moves frame_ms."""
from tracing import SYNC_CALLS


def read(trace):
    if trace.unit != "frame" or not trace.units:
        return None
    return trace.host_calls(SYNC_CALLS, inside="frame") / trace.units
