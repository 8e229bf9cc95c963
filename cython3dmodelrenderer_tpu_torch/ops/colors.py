"""The fallback colours' expansion: (T, 3) uint8 colours, one a triangle,
to the (T, 3, 3) float32 colours, one a vertex, that the front end reads.

``vertex_colors(per_tri, device, stream)`` launches ``csrc/colors.cu``,
which reads ``per_tri`` straight from pinned host memory: no copy to the
card and no expand of PyTorch's. The caller keeps ``per_tri`` unchanged
until the launch has run on ``stream`` (``renderer._PinnedColors``
records an event after it). A CPU ``device`` runs ``vertex_colors_plain``;
the two agree bit for bit (a byte converts to float exactly).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import cuda_build
from ..utils import timing


def vertex_colors_plain(per_tri: torch.Tensor) -> torch.Tensor:
    """(T, 3) colours → (T, 3, 3) float32, each repeated for the three
    vertices of its triangle."""
    t = per_tri.shape[0]
    out = torch.empty((t, 3, 3), dtype=torch.float32, device=per_tri.device)
    return out.copy_(per_tri.unsqueeze(1).expand(t, 3, 3))


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("colors")
    p = ctypes.c_void_p
    lib.vertex_colors_launch.argtypes = [p, ctypes.c_int64, p, ctypes.c_int,
                                         p]
    lib.vertex_colors_launch.restype = ctypes.c_int
    return lib


def vertex_colors(per_tri: torch.Tensor, device: torch.device,
                  stream=None) -> torch.Tensor:
    """``vertex_colors_plain(per_tri)`` on ``device``. For a CUDA device,
    ``per_tri`` is a contiguous (T, 3) uint8 tensor in pinned memory and
    the kernel runs on ``stream``, a ``torch.cuda.Stream`` of ``device``
    (by default its current stream)."""
    if device.type == "cpu":
        return vertex_colors_plain(per_tri)
    if device.type != "cuda":
        raise ValueError(f"vertex_colors: unsupported device {device}")
    if (per_tri.dtype != torch.uint8 or per_tri.dim() != 2
            or per_tri.shape[1] != 3 or not per_tri.is_contiguous()):
        raise ValueError("vertex_colors reads a contiguous (T, 3) uint8 "
                         "tensor (in pinned host memory: the launch "
                         "refuses any other)")
    if stream is None:
        stream = torch.cuda.current_stream(device)
    t = per_tri.shape[0]
    out = torch.empty((t, 3, 3), dtype=torch.float32, device=device)
    lib = _lib()
    err = lib.vertex_colors_launch(per_tri.data_ptr(), t, out.data_ptr(),
                                   out.device.index, stream.cuda_stream)
    cuda_build.check(lib, err, "vertex_colors (csrc/colors.cu)")
    if t:
        timing.counters["launch.colors"] += 1
    return out
