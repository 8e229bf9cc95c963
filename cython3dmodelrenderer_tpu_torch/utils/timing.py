"""Timing and profiling helpers.

Counterpart of ``cython3dmodelrenderer_tpu/utils/timing.py``: a frame
timer fenced on the device, the ``FrameStats`` aggregate, and a context
manager around ``torch.profiler`` that writes a Chrome trace. CUDA-event
timing and device time under the profiler are ``measure.cuda_time_ms`` and
``measure.profile_calls``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import time
from typing import Callable, Optional

import torch


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
