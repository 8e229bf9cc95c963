"""The frame's front end — kernel F1 and its plain version.

Pose, cull, projection, fast shade, plane rows and tile spans of one frame
or of a batch of posed views, in one pass. In the JAX package this is XLA
glue, not a ``pallas_call`` site: its jitted frame fuses ``fillers.py:54``
(``_geometry_stage``), the fast-shade ``lambert_shade`` and
``ops/binning.py:52`` (``plane_data``) into a few XLA kernels, and its
sweep adds each view's pose (``parallel/multiview.py:64-77``). Eager
PyTorch ran the chain as ~150 operations a frame.

``frame_planes_plain`` is that chain, calling ``pose_triangles``,
``visibility_masks``, ``project_to_screen``, ``lambert_shade`` and
``plane_data`` view by view; ``frame_planes`` launches ``csrc/frontend.cu``
once for all views on CUDA tensors, one device operation that also
writes the pair total, and equals the plain version bit for bit (the
kernel rounds every multiply and add on its own, divides and takes
square roots by IEEE rules). Both return the frame's pair total as a
0-dim int64 tensor, so the caller's one host read is of that scalar.
``frontend_plan`` mirrors the launcher's sizes on the CPU.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from .. import cuda_build
from ..config import RenderConfig
from . import binning
from .illumination import lambert_shade
from .projection import project_to_screen, projection_matrix, visibility_masks
from .transforms import _matmul3

Planes = Tuple[torch.Tensor, ...]


def pose_triangles(tri_verts: torch.Tensor, tri_norms: torch.Tensor,
                   pose: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``v @ Rᵀ + shift`` and ``n @ Rᵀ`` with ``pose`` = (4, 3) ``Rᵀ``
    over the shift, as explicit 3-term products (``_matmul3``)."""
    return _matmul3(tri_verts, pose[:3]) + pose[3], _matmul3(tri_norms,
                                                             pose[:3])


def _check_args(n_attrs: int, tri_colors, shade) -> None:
    if n_attrs not in (0, 3, 6):
        raise ValueError(f"n_attrs must be 0, 3 or 6, got {n_attrs}")
    if n_attrs and tri_colors is None:
        raise ValueError(f"n_attrs={n_attrs} needs the vertex colours")
    if shade is not None and not n_attrs:
        raise ValueError("shading needs colour channels")


def frame_planes_plain(tri_verts: torch.Tensor, tri_norms: torch.Tensor,
                       tri_colors: Optional[torch.Tensor], config: RenderConfig,
                       n_attrs: int, tile_h: int, tile_w: int, shade=None,
                       poses: Optional[torch.Tensor] = None) -> Planes:
    """F1's plain version: ``frame_planes`` as PyTorch ops, view by view
    (the per-view loop the sweep ran before F1), on the tensors' device."""
    _check_args(n_attrs, tri_colors, shade)
    nty = -(-config.height // tile_h)
    views = [None] if poses is None else poses.to(tri_verts.device)
    parts = []
    for v, pose in enumerate(views):
        tv, tn = ((tri_verts, tri_norms) if pose is None
                  else pose_triangles(tri_verts, tri_norms, pose))
        degenerate, backfacing = visibility_masks(tv, tn)
        colors = normals = None
        if n_attrs:
            colors = tri_colors.to(torch.float32)
            if shade is not None:       # Gouraud: Lambert baked per vertex
                colors = lambert_shade(colors, tn, shade)
            if n_attrs == binning.N_ATTRS:
                normals = tn
        rows, tx0, cx, ty0, cy, counts = binning.plane_data(
            project_to_screen(tv, config), ~degenerate & ~backfacing, config,
            tile_h, tile_w, colors=colors, normals=normals)
        parts.append((rows, tx0, cx, ty0 + v * nty if v else ty0, cy, counts))
    out = parts[0] if len(parts) == 1 else tuple(torch.cat(xs)
                                                 for xs in zip(*parts))
    return (*out, out[-1].sum(dtype=torch.int64))


#: (view, triangle)s a block of F1 (``csrc/frontend.cu`` ``kThreads``)
THREADS = 128
#: the static shared memory a block may have without the dynamic opt-in
SMEM_LIMIT = 48 * 1024


class FrontendPlan(NamedTuple):
    """How ``frame_planes`` sizes a launch of F1 (``csrc/frontend.cu``).

    The rows are allocated in whole blocks (``padded_rows``), each block's
    chunk one bulk copy; rows, spans and the total share one int32 buffer
    of ``words``: rows at 0, spans at ``spans_at``, the int64 total at the
    even word ``total_at``."""
    threads: int
    blocks: int
    smem_bytes: int
    padded_rows: int
    spans_at: int
    total_at: int
    words: int


def frontend_plan(n: int, n_attrs: int) -> FrontendPlan:
    """F1's launch for ``n`` (view, triangle)s with ``n_attrs`` channels:
    one block a ``THREADS`` of them (one block with none, to write the
    total), and the block's static shared memory (``Staging``): the staged
    rows, the vertices and normals (and colours), and a pair count a
    warp."""
    width = binning.row_width(n_attrs)
    blocks = -(-n // THREADS)
    smem = 4 * THREADS * (width + 9 * (3 if n_attrs else 2)) + 8 * (THREADS // 32)
    padded = blocks * THREADS
    spans_at = padded * width
    total_at = spans_at + 5 * n + (5 * n) % 2
    return FrontendPlan(THREADS, max(blocks, 1), smem, padded, spans_at,
                        total_at, total_at + 2)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built F1 library, its argument types bound once."""
    return bind(cuda_build.load("frontend"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare ``frontend_launch``'s and ``frontend_constants``' C
    signatures on a loaded library."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.frontend_launch.argtypes = [p, p, p, p, i, i, p, i, i, i, i, i, i,
                                    f, f, f, p, p, p, p, i, p]
    lib.frontend_launch.restype = ctypes.c_int
    lib.frontend_constants.argtypes = [i, p]
    lib.frontend_constants.restype = None
    return lib


def kernel_constants(n_attrs: int) -> dict:
    """The built kernel's own launch constants for ``n_attrs`` (card): to
    hold ``frontend_plan`` against, with its registers and spills."""
    out = (ctypes.c_int * 4)()
    _lib().frontend_constants(n_attrs, out)
    return dict(zip(("threads", "smem_bytes", "registers", "local_bytes"), out))


_PROJECTIONS: dict = {}
_SYNC: dict = {}


def projection_floats(config: RenderConfig) -> ctypes.Array:
    """The 16 ctypes floats of ``projection_matrix(config)``, built once per
    (fov, aspect, z_near, z_far)."""
    key = (config.fov, config.aspect, config.z_near, config.z_far)
    pm = _PROJECTIONS.get(key)
    if pm is None:
        pm = _PROJECTIONS[key] = (ctypes.c_float * 16)(
            *projection_matrix(config).ravel().tolist())
    return pm


def _sync_words(dev: torch.device, stream: int) -> torch.Tensor:
    """F1's accumulator and ticket on ``stream``: zeroed once, and left
    zeroed by each launch's last block."""
    key = (dev.index, stream)
    words = _SYNC.get(key)
    if words is None:
        words = _SYNC[key] = torch.zeros(2, dtype=torch.int64, device=dev)
    return words


def frame_planes(tri_verts: torch.Tensor, tri_norms: torch.Tensor,
                 tri_colors: Optional[torch.Tensor], config: RenderConfig,
                 n_attrs: int, tile_h: int, tile_w: int, shade=None,
                 poses: Optional[torch.Tensor] = None) -> Planes:
    """The front end of ``V`` views of (T, 3, 3) triangles: ``(rows
    (V·T, 16 + 3·n_attrs) f32, tx0, cx, ty0, cy, counts (V·T,) int32,
    total (0-dim int64))``, view v's rows at ``v·T + i`` and its ``ty0``
    offset by ``v·nty`` (the stacked ``ntx x V·nty`` grid).

    ``n_attrs``: 0 (geometry only; ``tri_colors`` may be None), 3 (the
    colour channels) or 6 (colours, then the normals). ``shade``: None,
    or the pre-negated unit light to bake Lambert into the vertex colours
    with the (posed) normals (fast shade). ``poses``: None for one view
    as given, or (V, 4, 3) float32 — ``Rᵀ`` over the shift of each view.

    CUDA tensors launch kernel F1 (``csrc/frontend.cu``) once, one device
    operation (``frontend_plan``; the rows are a view of whole blocks of
    rows, the outputs views of one buffer); CPU tensors run
    ``frame_planes_plain``; any other device raises.
    """
    dev = tri_verts.device
    if dev.type == "cpu":
        return frame_planes_plain(tri_verts, tri_norms, tri_colors, config,
                                  n_attrs, tile_h, tile_w, shade, poses)
    if dev.type != "cuda":
        raise ValueError(f"frame_planes: unsupported device {dev}")
    _check_args(n_attrs, tri_colors, shade)
    if tri_verts.dtype != torch.float32 or tri_norms.dtype != torch.float32:
        raise ValueError("frame_planes: vertices and normals must be float32")
    t = tri_verts.shape[0]
    if tri_verts.shape != (t, 3, 3) or tri_norms.shape != (t, 3, 3):
        raise ValueError(f"frame_planes: (T, 3, 3) arrays expected, got "
                         f"{tuple(tri_verts.shape)}, {tuple(tri_norms.shape)}")
    verts, norms = tri_verts.contiguous(), tri_norms.contiguous()
    colors = None
    if n_attrs:
        colors = tri_colors.to(device=dev, dtype=torch.float32).contiguous()
        if colors.shape != (t, 3, 3):
            raise ValueError(f"frame_planes: colours {tuple(colors.shape)}")
    n_views = 1
    if poses is not None:
        poses = poses.to(device=dev, dtype=torch.float32).contiguous()
        n_views = poses.shape[0]
        if poses.shape != (n_views, 4, 3) or n_views < 1:
            raise ValueError(f"frame_planes: poses {tuple(poses.shape)}")
    n = n_views * t
    plan = frontend_plan(n, n_attrs)
    out = torch.empty(plan.words, dtype=torch.int32, device=dev)
    rows = out[:plan.spans_at].view(torch.float32).view(
        plan.padded_rows, binning.row_width(n_attrs))
    spans = out[plan.spans_at:plan.spans_at + 5 * n].view(5, n)
    total = out[plan.total_at:].view(torch.int64)[0]
    light = shade if shade is not None else (0.0, 0.0, 0.0)
    stream = cuda_build.stream_handle(dev)
    lib = _lib()
    err = lib.frontend_launch(
        verts.data_ptr(), norms.data_ptr(),
        colors.data_ptr() if colors is not None else None,
        poses.data_ptr() if poses is not None else None, t, n_views,
        projection_floats(config), config.width, config.height, tile_w,
        tile_h, n_attrs, int(shade is not None), *(float(x) for x in light),
        rows.data_ptr(), spans.data_ptr(), total.data_ptr(),
        _sync_words(dev, stream).data_ptr(), dev.index, stream)
    cuda_build.check(lib, err, "frame_planes (csrc/frontend.cu)")
    frame_planes.launches += 1
    return (rows[:n], *spans.unbind(0), total)


#: kernel launches made by ``frame_planes`` (one per call on a CUDA tensor)
frame_planes.launches = 0
