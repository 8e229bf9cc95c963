"""Stutter: the 95th percentile of every frame's latency in the window,
from the ``render`` call to the image complete on the card, by the host
clock."""
import statistics


def read(window):
    if window.unit != "frame" or len(window.latencies) < 20:
        return None
    return 1e3 * statistics.quantiles(window.latencies, n=20,
                                      method="inclusive")[18]
