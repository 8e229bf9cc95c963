"""Reading a traced window: stage ranges, host calls and device operations.

The traced run wraps the program's calls in ``record_function`` ranges
named ``stage:<stage>`` (``stage_ranges``; the method and the targets are
those of the repository's frame profiler), runs its steps under
``torch.profiler`` inside one ``bench:window`` range, and reads the
profiler's events in memory (``Trace``): no trace file is written.
"""
from __future__ import annotations

import contextlib
import functools
from typing import List, Optional, Tuple

#: host calls that enqueue device work (the CUDA runtime and ``cu*`` calls)
LAUNCH_CALLS = frozenset((
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
    "cuLaunchKernelEx", "cudaLaunchCooperativeKernel", "cudaMemsetAsync",
    "cudaMemcpyAsync", "cudaMemset", "cudaMemcpy"))
#: host calls that wait for the device
SYNC_CALLS = frozenset((
    "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
    "cudaMemcpy", "cuStreamSynchronize", "cuCtxSynchronize"))
WINDOW = "bench:window"

Interval = Tuple[str, float, float]       # (name, start µs, end µs)


def stage_targets():
    """(stage, owner, attribute) of each program call the traced run
    wraps; a target the program no longer has is skipped."""
    import cython3dmodelrenderer_tpu_torch as program
    from cython3dmodelrenderer_tpu_torch.ops import raster
    from cython3dmodelrenderer_tpu_torch.parallel import multiview

    return [("frame", program.Renderer, "render"),
            ("frame", program.Renderer, "render_sequence"),
            ("render_frame", raster, "render_frame"),
            ("render_frame", multiview, "_render_view_batch"),
            ("front_end", raster, "frame_planes"),
            ("front_end", multiview, "_stacked_planes"),
            ("bins", raster, "route_bins"),
            ("raster", raster, "raster_tiles")]


@contextlib.contextmanager
def stage_ranges(targets):
    """Wrap each target in a ``record_function`` range named
    ``stage:<stage>``; restore them on exit."""
    from torch.profiler import record_function

    saved = []
    for stage, owner, attr in targets:
        fn = getattr(owner, attr, None)
        if fn is None:
            continue

        def wrapped(*args, _fn=fn, _name=f"stage:{stage}", **kwargs):
            with record_function(_name):
                return _fn(*args, **kwargs)

        saved.append((owner, attr, fn))
        setattr(owner, attr, functools.wraps(fn)(wrapped))
    try:
        yield
    finally:
        for owner, attr, fn in reversed(saved):
            setattr(owner, attr, fn)


def short_name(name: str) -> str:
    """A kernel's function name without return type, namespaces, template
    arguments and parameters; another operation's name up to its first
    parenthesis."""
    s = name.replace("(anonymous namespace)::", "").strip()
    if s.startswith("void "):
        s = s[len("void "):]
    return s.split("(")[0].split("<")[0].split("::")[-1].strip()


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merge intervals into disjoint ones, in order."""
    merged: List[List[float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


def clip(intervals, lo: float, hi: float):
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if min(b, hi) > max(a, lo)]


class Trace:
    """One traced window: host events, device operations and the counts
    of work in it. Times are the profiler's microseconds."""

    def __init__(self, host: List[Interval], device: List[Interval],
                 window: Tuple[float, float], steps: int, units: int,
                 unit: str):
        self.host, self.window = host, window
        lo, hi = window
        self.device = [e for e in device if lo <= e[1] <= hi]
        self.steps, self.units, self.unit = steps, units, unit
        #: bound seconds of the traced steps by kernel group (``bounds.py``)
        self.bounds: dict = {}
        #: seconds a unit of work took in the untraced window
        self.seconds_per_unit: Optional[float] = None

    @classmethod
    def from_profiler(cls, prof, **kwargs) -> "Trace":
        host, device, window = [], [], None
        for e in prof.events():
            kind = str(e.device_type)
            span = (e.name, float(e.time_range.start), float(e.time_range.end))
            if kind.endswith("CPU"):
                host.append(span)
                if e.name == WINDOW:
                    window = span[1:]
            elif kind.endswith("CUDA") and not e.name.startswith(
                    ("stage:", "bench:")):
                device.append(span)
        if window is None:
            raise RuntimeError("the traced window's range is missing")
        return cls(host, device, window, **kwargs)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_intervals(self):
        return union(clip([(a, b) for _n, a, b in self.device], *self.window))

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def kernel_count(self, names) -> int:
        return sum(short_name(n) in names for n, _a, _b in self.device)

    def kernel_seconds(self, names) -> float:
        return sum(b - a for n, a, b in self.device
                   if short_name(n) in names) / 1e6

    def host_calls(self, names, inside: Optional[str] = None) -> int:
        """Host calls named in ``names`` in the window; with ``inside``,
        only those within a ``stage:<inside>`` range."""
        lo, hi = self.window
        ranges = ([(a, b) for n, a, b in self.host if n == f"stage:{inside}"]
                  if inside else [(lo, hi)])
        return sum(1 for n, a, _b in self.host
                   if n in names and lo <= a <= hi
                   and any(r0 <= a <= r1 for r0, r1 in ranges))

    def stage_at(self, t: float) -> str:
        """The innermost stage range the host was in at ``t``."""
        inner = [(b - a, n) for n, a, b in self.host
                 if n.startswith("stage:") and a <= t <= b]
        return min(inner)[1] if inner else "harness"

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps labelled with the stage the host was in at their middle."""
        by_name: dict = {}
        for n, a, b in self.device:
            key = short_name(n)
            by_name[key] = by_name.get(key, 0.0) + (b - a) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        lo, hi = self.window
        edges = [lo] + [x for iv in self.busy_intervals() for x in iv] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[self.stage_at((a + b) / 2), (b - a) / 1e6]
                              for a, b in gaps]}

    def roofline(self, group: str, names) -> Optional[float]:
        """Percent of the kernels' device time that their bound is."""
        spent = self.kernel_seconds(names)
        bound = self.bounds.get(group)
        if not spent or not bound:
            return None
        return 100.0 * bound / spent
