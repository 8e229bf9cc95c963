"""Rasterization rules shared by the port's rasterizers.

So far only ``bbox_ceil`` of ``cython3dmodelrenderer_tpu/ops/raster_ref.py``:
the full ratio-form torch oracle is still to be ported.
"""
from __future__ import annotations

import torch


def _clipped_ceil(v: torch.Tensor, hi: int) -> torch.Tensor:
    # NaN (a vertex on the camera plane) becomes 0, like XLA's f32→s32
    return torch.clamp(torch.ceil(v), 0, hi).nan_to_num(0.0).to(torch.int32)


def bbox_ceil(tri_xy: torch.Tensor, width: int, height: int):
    """Clipped ceil-based bbox per triangle (reference py filler:131-134).

    tri_xy: (T, 3, 2) screen xy. Returns (xl, xr, yl, yr) int32 tensors; the
    candidate pixel range is [xl, xr) × [yl, yr).
    """
    x = tri_xy[..., 0]
    y = tri_xy[..., 1]
    xl = _clipped_ceil(x.amin(dim=1), width)
    xr = _clipped_ceil(x.amax(dim=1), width)
    yl = _clipped_ceil(y.amin(dim=1), height)
    yr = _clipped_ceil(y.amax(dim=1), height)
    return xl, xr, yl, yr
