"""Multi-view sweeps: a pose sequence rendered in view batches.

Counterpart of ``cython3dmodelrenderer_tpu/parallel/multiview.py`` for the
sweep path: ``render_sequence_pallas`` (``:534``) and
``render_turntable_pallas`` (``:352``) through ``_run_sweep`` (``:308``),
with ``turntable_angles``, ``_pose_triangles``, ``_norm_light`` and the
capacity helpers.

A batch of ``view_batch`` consecutive poses renders as one stacked frame
(``_render_view_batch``, the counterpart of ``_batched_view_spans`` +
``_render_viewbatch_pallas``): each view is posed, culled, projected and
turned into plane rows on its own; the views' spans are stacked on one
``ntx x (V·nty)`` tile grid (view v's ``ty0`` offset by ``v·nty``) and
their plane rows one after another (view v's triangle i at row ``v·T + i``).
Every (view, tile) bin then holds only that view's triangles, in ascending
order, so one binning pass (B2's sort route or B4's counting sort,
``raster.route_bins``, with no kernel change) and ONE launch of B1 with a
view index (``raster_tiles(n_views=V)``) render the batch, each view
bit-identical to its render alone. ``view_batch=1`` is the single-view
frame.

The JAX sweep also moves each view's y-bbox to stacked image coordinates
and pads each view's tile rows to ``view_row_stride(nty, group)``: a TPU
chunk tail can read rows of another view, which the stacked bbox test
rejects, and the grouped binner composes groups over the padded grid. The
port's exact per-(view, tile) bins never hold another view's rows, so
neither is copied; the stride enters only the budget test that routes a
batch (``raster.route_bins``).

Capacity: the port sizes every batch exactly, with one host read of the
batch's pair total, so nothing can overflow: ``p_cap`` and ``g_cap`` are
accepted and have no effect, and ``check_capacity=True`` returns the peak
per-batch pair total — the port's demand, not JAX's slot bucket.

Posing uses the port's explicit 3-term products (``transforms._matmul3``),
never ``matmul``/``einsum``. The rotation matrix is built on the host by
``rotation_matrix`` (looked up through this module), so posed geometry is
the same on the CPU and on the card.

Not ported here: ``render_view`` and ``render_turntable`` (the jnp
backend) need the ratio-form torch oracle (ROADMAP queue A item 4);
``render_turntable_sharded``, ``render_triangle_sharded`` and
``triangle_shard_capacity`` are multi-GPU work (item 12). They raise
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..config import RenderConfig
from ..ops import binning, raster
from ..ops.binsort import expand_pairs, grouped_limits_ok
from ..ops.illumination import lambert_shade
from ..ops.projection import project_to_screen, visibility_masks
from ..ops.transforms import _matmul3, rotation_matrix

POSTS = ("f32", "u8")


def _host_f32(x) -> np.ndarray:
    """Angles or shifts as a host float32 array, a copy (a tensor may be
    on the card; poses are host data)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.array(x, dtype=np.float32)


def turntable_angles(n_views: int) -> torch.Tensor:
    """(N, 3) float32 Euler XYZ angle triples of a y-axis turntable sweep:
    ``jnp.linspace(0, 360, N, endpoint=False)`` evaluated as JAX does
    (``0·(1 - s) + 360·s`` with ``s = iota / N`` in float32, which is the
    product ``360·s``), so the angles are bit-equal."""
    deg = np.float32(360.0) * (np.arange(n_views, dtype=np.float32)
                               / np.float32(max(n_views, 1)))
    zeros = np.zeros_like(deg)
    return torch.from_numpy(np.stack([zeros, deg, zeros], axis=1))


def _pose_triangles(tri_verts: torch.Tensor, tri_norms: torch.Tensor,
                    angles, post_shift) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotate triangles and normals by Euler angles (degrees), then
    translate the triangles: ``v @ Rᵀ + shift`` and ``n @ Rᵀ``
    (``multiview.py:64-77``)."""
    rt = rotation_matrix(_host_f32(angles), device="cpu").T
    rt = rt.to(tri_verts.device)
    shift = torch.as_tensor(_host_f32(post_shift), device=tri_verts.device)
    return _matmul3(tri_verts, rt) + shift, _matmul3(tri_norms, rt)


def _norm_light(light_direction) -> Optional[np.ndarray]:
    """The pre-negated unit light in float32, or None (no illumination):
    ``-l / ‖l‖`` with ``‖l‖ = sqrt((x² + y²) + z²)``, XLA's reduction
    order (``multiview.py:101-107``)."""
    if light_direction is None:
        return None
    light = -_host_f32(light_direction)
    x, y, z = light
    return light / np.sqrt((x * x + y * y) + z * z)


def _stacked_planes(tri_verts, tri_norms, tri_colors, angles_b, shifts_b,
                    config: RenderConfig, light=None, fast: bool = False,
                    lean: bool = False):
    """Pose, cull, project and plane-stage a batch of views, stacked: rows
    ``(V·T, R)`` view after view, spans on the ``ntx x V·nty`` grid.
    ``tri_colors=None`` gives geometry-only rows (the demand helpers).
    Shared by the batch renderer and ``sequence_demand``, as JAX's
    ``_batched_view_spans`` is, so the two see the same pairs."""
    nty = -(-config.height // raster.TILE_H)
    parts = []
    for v in range(len(angles_b)):
        pv, pn = _pose_triangles(tri_verts, tri_norms, angles_b[v], shifts_b[v])
        degenerate, backfacing = visibility_masks(pv, pn)
        colors, normals = tri_colors, pn
        if tri_colors is None:
            normals = None
        elif fast:          # Gouraud: Lambert baked with the POSED normals
            colors, normals = lambert_shade(tri_colors, pn, light), None
        elif lean:          # unlit u8: the normal channels are never read
            normals = None
        rows, tx0, cx, ty0, cy, counts = binning.plane_data(
            project_to_screen(pv, config), ~degenerate & ~backfacing, config,
            raster.TILE_H, raster.TILE_W, colors=colors, normals=normals)
        parts.append((rows, tx0, cx, ty0 + v * nty, cy, counts))
    return tuple(torch.cat(xs) for xs in zip(*parts))


def _render_view_batch(tri_verts, tri_norms, tri_colors, angles_b, shifts_b,
                       config: RenderConfig, group: int, light, fast: bool,
                       post: str, backend: str) -> Tuple[torch.Tensor, int]:
    """A batch of posed views through one binning pass and ONE raster
    launch. Returns ((V, H, W, 3) images — uint8 for ``post="u8"``, else
    float32 — and the batch's pair total, its one host read)."""
    n_views = len(angles_b)
    h, w = config.height, config.width
    ntx, nty = -(-w // raster.TILE_W), -(-h // raster.TILE_H)
    lean = post == "u8" and light is None and not fast
    n_attrs = 3 if (fast or lean) else binning.N_ATTRS
    rows, tx0, cx, ty0, cy, counts = _stacked_planes(
        tri_verts, tri_norms, tri_colors, angles_b, shifts_b, config,
        light=light, fast=fast, lean=lean)
    total = int(counts.sum())
    bins = raster.route_bins(tx0, cx, ty0, cy, ntx, nty, total, group,
                             backend, n_views)
    rast = raster.raster_tiles if backend == "cuda" else raster.raster_tiles_plain
    if post == "u8":         # shaded (unless pre-shaded or unlit) in-kernel
        _gbuf, img = rast(rows, *bins, ntx, nty, h, w, n_attrs, config.z_init,
                          light=None if (fast or light is None) else light,
                          gbuffer=False, image=True, n_views=n_views)
    else:                    # f32: the G-buffer, shaded outside the kernel
        (img, _z, normal), _img = rast(rows, *bins, ntx, nty, h, w, n_attrs,
                                       config.z_init, gbuffer=True,
                                       n_views=n_views)
        if not (fast or light is None):
            img = lambert_shade(img, normal, light)
    return img.reshape(n_views, h, w, 3), total


def _run_sweep(tri_verts, tri_norms, tri_colors, angles, shifts,
               config: RenderConfig, group: int, light, post: str,
               view_batch: int, fast_shade: bool,
               backend: str) -> Tuple[torch.Tensor, int]:
    """The one sweep behind the turntable and sequence entry points:
    consecutive batches of ``view_batch`` poses. Returns the (N, H, W, 3)
    frames and the peak per-batch pair total."""
    n = angles.shape[0]
    if view_batch < 1 or n % view_batch:
        raise ValueError(f"view_batch={view_batch} must divide {n} poses")
    if post not in POSTS:
        raise ValueError(f"unknown post {post!r}; expected one of {POSTS}")
    if fast_shade and light is None:
        raise ValueError("fast_shade needs a light direction "
                         "(it bakes Lambert per vertex)")
    tri_colors = tri_colors.to(torch.float32)
    images, peak = [], 0
    for b0 in range(0, n, view_batch):
        img, total = _render_view_batch(
            tri_verts, tri_norms, tri_colors, angles[b0:b0 + view_batch],
            shifts[b0:b0 + view_batch], config, group, light, fast_shade,
            post, backend)
        images.append(img)
        peak = max(peak, total)
    if not images:
        dtype = torch.uint8 if post == "u8" else torch.float32
        return torch.zeros((0, config.height, config.width, 3), dtype=dtype,
                           device=tri_verts.device), 0
    return torch.cat(images), peak


def render_sequence_pallas(tri_verts: torch.Tensor, tri_norms: torch.Tensor,
                           tri_colors: torch.Tensor, angles, shifts,
                           config: RenderConfig, p_cap: int = 0,
                           chunk: int = 128, light_direction=(0.0, 0.0, 1.0),
                           interpret: bool = False, group: int = raster.GROUP,
                           check_capacity: bool = False, post: str = "f32",
                           view_batch: int = 1, fast_shade: bool = False,
                           g_cap: int = 0, backend: str = "cuda"):
    """Render a pose sequence: frame i rotates the model by ``angles[i]``
    (Euler XYZ degrees) and translates it by ``shifts[i]``.

    Returns (N, H, W, 3) frames, float32 (``post="f32"``) or uint8
    (``post="u8"``: shaded and quantised in B1). ``light_direction=None``
    is NoIllumination (raw interpolated colours). ``view_batch=V`` (V
    dividing N) renders V consecutive views per binning pass and B1
    launch; every view is bit-identical to ``view_batch=1``.
    ``fast_shade=True`` bakes Lambert per vertex with each view's posed
    normals and carries 3 attribute channels (``render_frame``'s
    ``"fast_lambert_u8"``). ``check_capacity=True`` also returns the peak
    per-batch pair total (module docstring). ``backend``: ``"cuda"`` =
    the kernels' wrappers (CPU tensors run their plain versions),
    ``"torch"`` = the plain versions. ``p_cap``, ``chunk``, ``interpret``
    and ``g_cap`` are accepted and have no effect.
    """
    del p_cap, chunk, interpret, g_cap
    images, peak = _run_sweep(
        tri_verts, tri_norms, tri_colors, _host_f32(angles).reshape(-1, 3),
        _host_f32(shifts).reshape(-1, 3), config, group,
        _norm_light(light_direction), post, view_batch, fast_shade, backend)
    return (images, peak) if check_capacity else images


def render_turntable_pallas(tri_verts: torch.Tensor, tri_norms: torch.Tensor,
                            tri_colors: torch.Tensor, angles,
                            config: RenderConfig, p_cap: int = 0,
                            post_shift=(0.0, 0.0, 1.0), chunk: int = 128,
                            light_direction=(0.0, 0.0, 1.0),
                            interpret: bool = False, group: int = raster.GROUP,
                            check_capacity: bool = False, post: str = "f32",
                            view_batch: int = 1, fast_shade: bool = False,
                            g_cap: int = 0, backend: str = "cuda"):
    """``render_sequence_pallas`` with one shift, ``post_shift``, for
    every view. ``tri_verts`` should be centred (``fit_model`` without its
    final z shift)."""
    angles = _host_f32(angles).reshape(-1, 3)
    shifts = np.broadcast_to(_host_f32(post_shift), angles.shape)
    return render_sequence_pallas(
        tri_verts, tri_norms, tri_colors, angles, shifts, config,
        light_direction=light_direction, group=group,
        check_capacity=check_capacity, post=post, view_batch=view_batch,
        fast_shade=fast_shade, backend=backend)


def sequence_demand(tri_verts, tri_norms, angles, shifts,
                    config: RenderConfig, headroom: float = 1.5,
                    post_shift=(0.0, 0.0, 1.0), group: int = raster.GROUP,
                    view_batch: int = 1) -> Tuple[int, int]:
    """(p_cap, g_cap) covering a pose sequence (``shifts=None`` → the
    fixed ``post_shift``), for API parity with ``multiview.py:442``.

    ``p_cap`` is the peak per-batch pair total — the port's demand, what
    ``check_capacity`` returns — times ``headroom``; ``g_cap`` is JAX's
    live-group bound from the peak count of nonempty (view, tile) bins,
    with the same headroom, rounded up to 4 groups, and 0 when every batch
    is past the grouped budget. The port's sweeps size each batch exactly
    and ignore both.
    """
    angles = _host_f32(angles).reshape(-1, 3)
    shifts = (np.broadcast_to(_host_f32(post_shift), angles.shape)
              if shifts is None else _host_f32(shifts).reshape(-1, 3))
    n = angles.shape[0]
    if view_batch < 1 or n % view_batch:
        raise ValueError(f"view_batch={view_batch} must divide {n} poses")
    ntx = -(-config.width // raster.TILE_W)
    nty = -(-config.height // raster.TILE_H)
    grouped = grouped_limits_ok(view_batch * tri_verts.shape[0], 0, ntx,
                                view_batch * raster.view_row_stride(nty, group))
    peak = act = 0
    for b0 in range(0, n, view_batch):
        _rows, tx0, cx, ty0, cy, counts = _stacked_planes(
            tri_verts, tri_norms, None, angles[b0:b0 + view_batch],
            shifts[b0:b0 + view_batch], config)
        total = int(counts.sum())
        peak = max(peak, total)
        if grouped:
            _tri, tile = expand_pairs(tx0, cx, ty0, cy, ntx, total)
            act = max(act, int(torch.unique(tile).numel()))
    if act <= 0:
        return int(peak * headroom), 0
    need = -(-int(act * headroom) // group)
    return int(peak * headroom), -(-need // 4) * 4


def sequence_capacity(tri_verts, tri_norms, angles, shifts,
                      config: RenderConfig, headroom: float = 1.5,
                      post_shift=(0.0, 0.0, 1.0), group: int = raster.GROUP,
                      view_batch: int = 1) -> int:
    """The ``p_cap`` of ``sequence_demand``."""
    return sequence_demand(tri_verts, tri_norms, angles, shifts, config,
                           headroom=headroom, post_shift=post_shift,
                           group=group, view_batch=view_batch)[0]


def turntable_capacity(tri_verts, tri_norms, config: RenderConfig,
                       n_samples: int = 8, headroom: float = 1.5,
                       post_shift=(0.0, 0.0, 1.0), group: int = raster.GROUP,
                       view_batch: int = 1) -> int:
    """``sequence_capacity`` over ``n_samples`` turntable angles."""
    return sequence_capacity(tri_verts, tri_norms, turntable_angles(n_samples),
                             None, config, headroom=headroom,
                             post_shift=post_shift, group=group,
                             view_batch=view_batch)


def render_view(*args, **kwargs):
    raise NotImplementedError("the jnp-backend views need the ratio-form "
                              "torch oracle, ROADMAP queue A item 4")


def render_turntable(*args, **kwargs):
    raise NotImplementedError("the jnp-backend turntable needs the ratio-form "
                              "torch oracle, ROADMAP queue A item 4")


def render_turntable_sharded(*args, **kwargs):
    raise NotImplementedError("view sharding is ROADMAP queue A item 12")


def render_triangle_sharded(*args, **kwargs):
    raise NotImplementedError("triangle sharding is ROADMAP queue A item 12")


def triangle_shard_capacity(*args, **kwargs):
    raise NotImplementedError("triangle sharding is ROADMAP queue A item 12")
