"""Timing and profiling helpers, and the program's own spans and counters.

Counterpart of ``cython3dmodelrenderer_tpu/utils/timing.py``: a frame
timer fenced on the device, the ``FrameStats`` aggregate, and a context
manager around ``torch.profiler`` that writes a Chrome trace. CUDA-event
timing and device time under the profiler are ``measure.cuda_time_ms`` and
``measure.profile_calls``.

The program measures itself in two ways:

* ``span(name)`` marks a stage of a frame or a sweep as a profiler range
  named ``stage:crender.<name>``, on the profiler's one timeline with the
  device operations. Without a running profiler it costs one check and
  enters nothing. The spans are ``render`` (a frame, ``Renderer.render``)
  and ``sequence`` (a sweep, ``Renderer.render_sequence``), and inside
  them ``fallback_colors`` (an untextured model's colours: the draw from
  the renderer's generator and the copy to the device), ``front_end``
  (F1's launch and its host preparation; in a sweep ``poses``, the host's
  pose build, nested in it), ``bins`` (the binning route), ``raster``
  (B1) and ``pair_total`` (the frame's one host read, after B1's launch;
  a frame that overflowed B4's capacity runs ``bins`` and ``raster``
  again after it).
* ``counters`` holds host numbers, always on: ``launch.<kernel>``
  (kernel launches by each CUDA wrapper), ``kernel_build_s`` and
  ``kernel_load_s`` (``cuda_build.load``), ``model_state_s``
  (``Model.from_state``), ``colors_gathered`` (gathers of a textured
  model's triangle colours, one a model), and ``fallback_draws_native``
  and ``fallback_draws_torch`` (an untextured model's colour draws, one a
  ``fallback_colors`` span with random colours: by
  ``native/mt_draw.cpp``, else by ``torch.randint``), and
  ``bins_capacity_fits`` and ``bins_capacity_reruns`` (one of them a
  frame or view batch, ``raster.frame_stages``: its pair total fit B4's
  capacity, or it overflowed and ran its bins and raster again). Seconds
  are ``time.perf_counter()`` intervals.
  A frame's pair count is the filler's ``last_pairs``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import tempfile
import time
from typing import Callable, Optional

import torch

#: the prefix of every span's profiler range
SPAN_PREFIX = "stage:crender."
#: the program's host counters (module docstring); callers read differences
counters: collections.Counter = collections.Counter()
#: what ``span`` returns while no profiler runs: reusable, enters nothing
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context manager marking the stage ``name``: a ``record_function``
    range ``stage:crender.<name>`` while a profiler runs, else the shared
    no-op ``_NO_SPAN`` (no range entered, nothing allocated)."""
    if not torch._C._autograd._profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(SPAN_PREFIX + name)


@dataclasses.dataclass
class FrameStats:
    """Per-frame render statistics."""

    ms_per_frame: float
    frames: int
    triangles: int
    #: triangle→tile pairs binned in the last frame (None for the ratio backend)
    pairs: Optional[int] = None
    #: non-empty image tiles in the last frame (None for the ratio backend)
    active_tiles: Optional[int] = None

    @property
    def mtris_per_sec(self) -> float:
        return self.triangles / self.ms_per_frame / 1e3


def _cuda_devices(out) -> set:
    """The CUDA devices of the tensors in ``out``: a tensor, a ``Buffer``
    (its ``array``), or nested tuples and lists of them."""
    if isinstance(out, (tuple, list)):
        return set().union(*(_cuda_devices(o) for o in out))
    out = getattr(out, "array", out)
    if isinstance(out, torch.Tensor) and out.device.type == "cuda":
        return {out.device}
    return set()


def _fence(out) -> None:
    """Wait for the devices that ``out`` lives on (none for CPU output)."""
    for dev in _cuda_devices(out):
        torch.cuda.synchronize(dev)


def time_frames(fn: Callable[[], object], n_warm: int = 3,
                n_iter: int = 20) -> float:
    """Mean wall ms per call of ``fn`` over ``n_iter`` calls after
    ``n_warm``, fenced with ``torch.cuda.synchronize()`` where the output
    lives on CUDA (host clock: the enqueue and the device work)."""
    for _ in range(n_warm):
        _fence(fn())
    t0 = time.perf_counter()
    out = None
    for _ in range(n_iter):
        out = fn()
    _fence(out)
    return (time.perf_counter() - t0) / n_iter * 1e3


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str] = None):
    """Profile a region with ``torch.profiler`` (the CPU, and the card when
    CUDA is available) and write ``<log_dir>/trace.json``, a Chrome trace
    (Perfetto opens it). ``log_dir`` defaults to ``crender_trace`` in the
    temporary directory. Yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "crender_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
