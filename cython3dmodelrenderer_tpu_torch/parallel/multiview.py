"""Multi-view sweeps: a pose sequence rendered in view batches.

Counterpart of ``cython3dmodelrenderer_tpu/parallel/multiview.py`` for the
sweep path: ``render_sequence_pallas`` (``:534``) and
``render_turntable_pallas`` (``:352``) through ``_run_sweep`` (``:308``),
with ``turntable_angles``, ``_pose_triangles``, ``_norm_light`` and the
capacity helpers; and for the ratio-form views: ``render_view`` (``:41``)
and ``render_turntable`` (``:80``), which JAX vmaps over the poses and the
port renders one pose after another through ``ops/raster_ref.py``.

A batch of ``view_batch`` consecutive poses renders as one stacked frame
(``_render_view_batch``, the counterpart of ``_batched_view_spans`` +
``_render_viewbatch_pallas``): one launch of the front-end kernel F1
(``ops/frontend.py::frame_planes``) poses, culls, projects and plane-stages
every view, each as it would alone; the views' spans are stacked on one
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

Posing uses the port's explicit 3-term products
(``frontend.pose_triangles``, and F1 the same products), never
``matmul``/``einsum``. The rotation matrix is built on the host by
``rotation_matrix`` (looked up through this module), so posed geometry is
the same on the CPU and on the card.

Multi-GPU: ``render_turntable_sharded`` (``:573``),
``triangle_shard_capacity`` (``:657``) and ``render_triangle_sharded``
(``:684``) run over a ``torch.distributed`` mesh (``parallel.mesh``). JAX's
one ``shard_map`` program becomes one process a rank: every rank passes the
same full inputs (JAX's replicated ``P()``), renders its own slice, and
JAX's ``pmin``/``pmax``/``psum`` become ``all_reduce`` on the mesh axis's
process group. The render itself never leaves the tensors' device.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import RenderConfig
from ..ops import binning, raster, raster_ref
from ..ops.binsort import expand_pairs, grouped_limits_ok
from ..ops.frontend import frame_planes, frame_planes_plain, pose_triangles
from ..ops.illumination import lambert_shade
from ..ops.projection import project_to_screen, visibility_masks
from ..ops.transforms import rotation_matrix
from ..utils import timing

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


def _pose_matrix(angles, post_shift) -> torch.Tensor:
    """(4, 3) host float32: ``Rᵀ`` of the Euler angles (degrees) over the
    shift, the pose ``frontend.pose_triangles`` and kernel F1 apply."""
    rt = rotation_matrix(_host_f32(angles), device="cpu").T
    return torch.cat([rt, torch.from_numpy(_host_f32(post_shift))[None]])


def _pose_triangles(tri_verts: torch.Tensor, tri_norms: torch.Tensor,
                    angles, post_shift) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotate triangles and normals by Euler angles (degrees), then
    translate the triangles: ``v @ Rᵀ + shift`` and ``n @ Rᵀ``
    (``multiview.py:64-77``)."""
    return pose_triangles(tri_verts, tri_norms,
                          _pose_matrix(angles, post_shift).to(tri_verts.device))


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
                    lean: bool = False, backend: str = "cuda"):
    """Pose, cull, project and plane-stage a batch of views, stacked: rows
    ``(V·T, R)`` view after view, spans on the ``ntx x V·nty`` grid, and
    the batch's pair total (0-dim int64) — ``frontend.frame_planes``, one
    launch of F1 for the batch (``backend="torch"``: its plain version).
    ``tri_colors=None`` gives geometry-only rows (the demand helpers);
    ``fast`` bakes Lambert into the colours with the POSED normals; a
    ``lean`` (unlit u8) batch never reads the normal channels. Shared by
    the batch renderer and ``sequence_demand``, as JAX's
    ``_batched_view_spans`` is, so the two see the same pairs."""
    with timing.span("poses"):
        poses = torch.stack([_pose_matrix(a, s)
                             for a, s in zip(angles_b, shifts_b)])
    n_attrs = (0 if tri_colors is None else 3 if (fast or lean)
               else binning.N_ATTRS)
    planes = frame_planes if backend == "cuda" else frame_planes_plain
    return planes(tri_verts, tri_norms, tri_colors, config, n_attrs,
                  raster.TILE_H, raster.TILE_W,
                  shade=light if fast else None, poses=poses)


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
    with timing.span("front_end"):
        rows, tx0, cx, ty0, cy, _counts, total = _stacked_planes(
            tri_verts, tri_norms, tri_colors, angles_b, shifts_b, config,
            light=light, fast=fast, lean=lean, backend=backend)
    with timing.span("pair_total"):
        total = int(total)                  # the batch's one host read
    with timing.span("bins"):
        bins = raster.route_bins(tx0, cx, ty0, cy, ntx, nty, total, group,
                                 backend, n_views)
    rast = raster.raster_tiles if backend == "cuda" else raster.raster_tiles_plain
    with timing.span("raster"):
        if post == "u8":     # shaded (unless pre-shaded or unlit) in-kernel
            _gbuf, img = rast(rows, *bins, ntx, nty, h, w, n_attrs,
                              config.z_init,
                              light=None if (fast or light is None) else light,
                              gbuffer=False, image=True, n_views=n_views)
        else:                # f32: the G-buffer, shaded outside the kernel
            (img, _z, normal), _img = rast(rows, *bins, ntx, nty, h, w,
                                           n_attrs, config.z_init,
                                           gbuffer=True, n_views=n_views)
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
        _rows, tx0, cx, ty0, cy, _counts, total = _stacked_planes(
            tri_verts, tri_norms, None, angles[b0:b0 + view_batch],
            shifts[b0:b0 + view_batch], config)
        total = int(total)
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


def render_view(tri_verts: torch.Tensor, tri_norms: torch.Tensor,
                tri_colors: torch.Tensor, config: RenderConfig,
                bbox_size: int = 64, chunk: int = 512,
                light_direction=(0.0, 0.0, 1.0)):
    """Project → rasterize (ratio form) → shade one view, on the tensors'
    device. Returns (shaded color, z, normal) float32 (JAX
    ``multiview.py:41-54``); ``bbox_size`` and ``chunk`` as in
    ``raster_ref.rasterize``."""
    degenerate, backfacing = visibility_masks(tri_verts, tri_norms)
    color, z, normal = raster_ref.rasterize(
        project_to_screen(tri_verts, config), tri_colors, tri_norms,
        ~degenerate & ~backfacing, config, bbox_size=bbox_size, chunk=chunk)
    return lambert_shade(color, normal, _norm_light(light_direction)), z, normal


def render_turntable(tri_verts: torch.Tensor, tri_norms: torch.Tensor,
                     tri_colors: torch.Tensor, angles, config: RenderConfig,
                     post_shift=(0.0, 0.0, 1.0), bbox_size: int = 64,
                     chunk: int = 512) -> torch.Tensor:
    """(N, H, W, 3) shaded float32 images: view i is ``render_view`` of the
    model posed by ``angles[i]`` (Euler XYZ degrees) and shifted by
    ``post_shift`` (JAX ``multiview.py:80-98``). ``tri_verts`` should be
    centred (``fit_model`` without its final z shift)."""
    views = []
    for angle3 in _host_f32(angles).reshape(-1, 3):
        v, n = _pose_triangles(tri_verts, tri_norms, angle3, post_shift)
        views.append(render_view(v, n, tri_colors, config,
                                 bbox_size=bbox_size, chunk=chunk)[0])
    if not views:
        return torch.zeros((0, config.height, config.width, 3),
                           dtype=torch.float32, device=tri_verts.device)
    return torch.stack(views)


# --------------------------------------------------------------------------
# Sharded rendering over a torch.distributed mesh
# --------------------------------------------------------------------------

INT32_MAX = torch.iinfo(torch.int32).max


def _mesh_axis(mesh, axis: str, device: torch.device):
    """(process group, size, this rank's coordinate) of mesh axis ``axis``;
    the mesh must live on the tensors' device type (its collectives take
    them)."""
    if mesh.device_type != device.type:
        raise ValueError(f"the mesh is on {mesh.device_type}, the tensors on "
                         f"{device}")
    group = mesh.get_group(axis)
    return group, dist.get_world_size(group), mesh.get_local_rank(axis)


def _mesh_max(value: int, group, device: torch.device) -> int:
    """The maximum of ``value`` over the ranks of ``group`` (JAX ``pmax``)."""
    t = torch.tensor([value], dtype=torch.int64, device=device)
    dist.all_reduce(t, dist.ReduceOp.MAX, group=group)
    return int(t.item())


def render_turntable_sharded(tri_verts, tri_norms, tri_colors, angles,
                             config: RenderConfig, mesh, axis: str = "views",
                             post_shift=(0.0, 0.0, 1.0), bbox_size: int = 64,
                             chunk: int = 512, backend: str = "ratio",
                             p_cap: Optional[int] = None,
                             interpret: bool = False,
                             group: int = raster.GROUP, view_batch: int = 1,
                             check_capacity: bool = False,
                             auto_resize: bool = True):
    """The turntable sharded over mesh axis ``axis``: the rank at
    coordinate r renders views ``[r·N/D, (r+1)·N/D)`` and returns its own
    ``(N/D, H, W, 3)`` float32 views (JAX ``out_specs=P(axis)``: the output
    stays sharded for the caller to gather or write out per shard). Every
    rank passes the same full inputs; ranks along another mesh axis render
    the same views.

    ``backend``: ``"ratio"`` = ``render_turntable`` (JAX ``"jnp"``, the
    default as in JAX); ``"cuda"`` / ``"torch"`` = ``render_turntable_pallas``
    (JAX ``"pallas"``) through the kernels' wrappers or their plain
    versions, with ``view_batch`` views a launch. ``check_capacity=True``
    also returns the mesh maximum of each rank's peak per-batch pair total
    (0 on ``"ratio"``). The port sizes every batch exactly, so nothing can
    overflow: ``p_cap``, ``auto_resize`` and ``interpret`` are accepted and
    have no effect.
    """
    del p_cap, interpret, auto_resize
    angles = _host_f32(angles).reshape(-1, 3)
    n = angles.shape[0]
    pg, n_dev, r = _mesh_axis(mesh, axis, tri_verts.device)
    if n % n_dev:
        raise ValueError(f"views ({n}) must divide over {n_dev} ranks")
    per = n // n_dev
    if view_batch > 1:
        if backend == "ratio":
            raise ValueError("view_batch requires a kernel backend "
                             "('cuda' or 'torch')")
        if per % view_batch:
            raise ValueError(f"view_batch={view_batch} must divide each "
                             f"rank's {per} views")
    mine = angles[r * per:(r + 1) * per]
    if backend == "ratio":
        images, peak = render_turntable(
            tri_verts, tri_norms, tri_colors, mine, config,
            post_shift=post_shift, bbox_size=bbox_size, chunk=chunk), 0
    else:
        images, peak = render_turntable_pallas(
            tri_verts, tri_norms, tri_colors, mine, config,
            post_shift=post_shift, group=group, check_capacity=True,
            view_batch=view_batch, backend=backend)
    if check_capacity:
        return images, _mesh_max(peak, pg, tri_verts.device)
    return images


def _shard(x: torch.Tensor, n_dev: int, r: int) -> torch.Tensor:
    """Rank r's contiguous slice of a triangle array; D must divide T."""
    t = x.shape[0]
    if t % n_dev:
        raise ValueError(f"triangles ({t}) must divide over {n_dev} ranks")
    return x[r * (t // n_dev):(r + 1) * (t // n_dev)]


def triangle_shard_capacity(tri_verts, tri_norms, config: RenderConfig,
                            mesh, axis: str = "tris",
                            group: int = raster.GROUP, headroom_num: int = 5,
                            headroom_den: int = 4) -> int:
    """The mesh maximum of the per-shard pair totals (each rank culls,
    projects and bins its shard), times ``headroom_num // headroom_den``
    in integers (JAX ``multiview.py:657``). JAX's ``capacity_bucket``
    rounding is not ported (ROADMAP A15), and neither is its grouped slot
    count: ``group`` is accepted and has no effect. The value is for API
    parity; the port's render sizes each shard exactly and ignores it."""
    del group
    pg, n_dev, r = _mesh_axis(mesh, axis, tri_verts.device)
    tv, tn = _shard(tri_verts, n_dev, r), _shard(tri_norms, n_dev, r)
    degenerate, backfacing = visibility_masks(tv, tn)
    counts = binning.plane_data(project_to_screen(tv, config),
                                ~degenerate & ~backfacing, config,
                                raster.TILE_H, raster.TILE_W)[-1]
    peak = _mesh_max(int(counts.sum()), pg, tri_verts.device)
    return peak * headroom_num // headroom_den


def _render_view_kernel(tri_verts, tri_norms, tri_colors, config: RenderConfig,
                        group: int, light, backend: str):
    """JAX ``_render_view_pallas(post="none")`` (``multiview.py:125-186``):
    the G-buffer frame (``raster.render_frame``), Lambert-shaded with the
    pre-negated unit ``light`` unless it is None. Returns (colour, z,
    normal, pair total)."""
    (color, z, normal), _img, total = raster.render_frame(
        tri_verts, tri_norms, tri_colors, config, post="none", group=group,
        backend=backend)
    if light is not None:
        color = lambert_shade(color, normal, light)
    return color, z, normal, total


def _merge_partials(color: torch.Tensor, z: torch.Tensor,
                    normal: torch.Tensor, rank: int, group):
    """The exact two-step z-argmin merge of JAX ``multiview.py:734-740``,
    in its order: the minimum depth over the shards, then the lowest shard
    among the exact-depth winners, whose colour and normal reach every rank
    as a SUM of ``where(win, x, 0.0)`` (with two or more ranks a winner's
    -0.0 reads +0.0, as in JAX). The merged z is the winner's own, sign
    and all, as JAX's ``pmin`` gives it: a SUM of ``where(win, z, -0.0)``,
    exact in any order of reduction (``w + -0.0 == w`` for every ``w``,
    ±0 included), carried in the same buffer as colour and normal — three
    all-reduces. Returns (colour, z (H, W, 1), normal)."""
    zmin = z[..., 0].clone(memory_format=torch.contiguous_format)
    dist.all_reduce(zmin, dist.ReduceOp.MIN, group=group)
    cand = z[..., 0] == zmin
    smin = torch.where(cand, rank, INT32_MAX).to(torch.int32)
    dist.all_reduce(smin, dist.ReduceOp.MIN, group=group)
    win = (cand & (smin == rank))[..., None]
    merged = torch.cat([torch.where(win, color, 0.0),
                        torch.where(win, z, -0.0),
                        torch.where(win, normal, 0.0)], dim=-1)
    dist.all_reduce(merged, dist.ReduceOp.SUM, group=group)
    return tuple(x.contiguous() for x in merged.split((3, 1, 3), dim=-1))


def render_triangle_sharded(tri_verts, tri_norms, tri_colors,
                            config: RenderConfig, mesh, axis: str = "tris",
                            bbox_size: int = 64, chunk: int = 512,
                            light_direction=(0.0, 0.0, 1.0),
                            backend: str = "ratio",
                            p_cap: Optional[int] = None,
                            interpret: bool = False,
                            group: int = raster.GROUP,
                            check_capacity: bool = False):
    """Shard the triangles over mesh axis ``axis`` and merge the partial
    frames by z-argmin (JAX ``multiview.py:684``).

    The rank at coordinate r renders triangles ``[r·T/D, (r+1)·T/D)`` into
    a full-resolution shaded colour, z and normal: ``backend="ratio"``
    through ``render_view`` (JAX ``"jnp"``), ``"cuda"`` / ``"torch"``
    through ``_render_view_kernel`` (JAX ``"pallas"``). ``_merge_partials``
    then gives every rank the merged ``(color, z, normal)`` (JAX
    ``out_specs=P()``). Shards hold contiguous triangle ranges, so the
    lowest shard among exact-z winners holds the lowest triangle, and the
    kernel backends' z equals the unsharded frame's on any rank count.
    ``check_capacity=True`` appends the mesh maximum of the shards' pair
    totals (0 on ``"ratio"``). ``p_cap`` and ``interpret`` are accepted and
    have no effect.
    """
    del p_cap, interpret
    pg, n_dev, r = _mesh_axis(mesh, axis, tri_verts.device)
    tv, tn, tc = (_shard(x, n_dev, r)
                  for x in (tri_verts, tri_norms, tri_colors))
    if backend == "ratio":
        color, z, normal = render_view(tv, tn, tc, config, bbox_size=bbox_size,
                                       chunk=chunk,
                                       light_direction=light_direction)
        used = 0
    else:
        color, z, normal, used = _render_view_kernel(
            tv, tn, tc, config, group, _norm_light(light_direction), backend)
    color, z, normal = _merge_partials(color, z, normal, r, pg)
    if check_capacity:
        return color, z, normal, _mesh_max(used, pg, tri_verts.device)
    return color, z, normal
