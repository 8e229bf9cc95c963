"""Reading the program's own spans in a traced window.

The program marks the stages of a frame as profiler ranges named
``stage:crender.<stage>`` (``cython3dmodelrenderer_tpu_torch/utils/
timing.py::span``): ``render`` (a frame), inside it ``front_end``,
``pair_total``, ``bins`` and ``raster``. They sit on the profiler's
timeline with the device operations, so host time in a stage and the
device's idle time can be intersected. A program without the spans gives
none, and every reading below is then None.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from tracing import clip, union

PREFIX = "stage:crender."
UNIT = "frame"

Intervals = List[Tuple[float, float]]


def spans(trace, stage: Optional[str] = None) -> Intervals:
    """(start, end) µs of the program's spans named ``stage`` (every
    program span with None) that start inside the traced window."""
    lo, hi = trace.window
    name = PREFIX + stage if stage else None
    return [(a, b) for n, a, b in trace.host
            if (n == name if name else n.startswith(PREFIX))
            and lo <= a <= hi]


def overlap(xs: Intervals, ys: Intervals) -> float:
    """The length of the intersection of two lists of disjoint, ordered
    intervals (``tracing.union`` gives such lists)."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        (a0, a1), (b0, b1) = xs[i], ys[j]
        total += max(0.0, min(a1, b1) - max(a0, b0))
        if a1 < b1:
            i += 1
        else:
            j += 1
    return total


def _per_unit(trace, us: float, found: bool) -> Optional[float]:
    if trace.unit != UNIT or not trace.units or not found:
        return None
    return us / trace.units


def host_us(trace, stage: str) -> Optional[float]:
    """µs a frame the host spent inside the ``stage`` span."""
    found = spans(trace, stage)
    return _per_unit(trace, sum(b - a for a, b in found), bool(found))


def self_us(trace, stage: str) -> Optional[float]:
    """µs a frame of the ``stage`` span's self time: its duration minus the
    part of it that the other program spans cover."""
    own = spans(trace, stage)
    children = union([(a, b) for n, a, b in trace.host
                      if n.startswith(PREFIX) and n != PREFIX + stage])
    covered = overlap(union(own), children)
    return _per_unit(trace, sum(b - a for a, b in own) - covered, bool(own))


def idle_intervals(trace) -> Intervals:
    """The traced window less the device's busy intervals."""
    lo, hi = trace.window
    edges = [lo] + [x for iv in trace.busy_intervals() for x in iv] + [hi]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def idle_in_program(trace) -> Optional[float]:
    """Percent of the window's device-idle time in which the host was
    inside a program span."""
    program = union(clip(spans(trace), *trace.window))
    idle = idle_intervals(trace)
    idle_us = sum(b - a for a, b in idle)
    if trace.unit != UNIT or not program or idle_us <= 0:
        return None
    return 100.0 * overlap(idle, program) / idle_us
