"""The frame's front end (``ops/frontend.py``, kernel F1's plain version)
against the JAX package's.

The JAX side is what its jitted frame runs: ``fillers._geometry_stage``
(visibility masks + projection), ``illumination.lambert_shade`` of the
vertex colours for fast shade, and ``binning.plane_data``, each under
``jax.jit``. It runs in a subprocess (this file, run as a script) with
``XLA_FLAGS=--xla_cpu_max_isa=AVX``: jit would otherwise contract
multiply-adds into FMAs (``test_torch_raster.py``). The port's
``frame_planes`` on CPU tensors must then agree BIT FOR BIT: plane rows
(every NaN canonical, as in ``test_torch_geometry.py``: IEEE leaves a
produced NaN's sign and payload open), spans, counts and the pair total.

Scenes: random triangles, an edge scene (a vertex on the camera plane,
one NaN x coordinate, a degenerate, a backfacing, a fully off-screen and
a huge clipped triangle, among triangles reaching past the image edges)
and no triangles, each with 0, 3 and 6 attribute channels and fast
shade. The posed batch (V = 3) is held against the per-view loop the
sweep ran before F1. The kernel itself needs the card:
``tests/test_torch_kernels_cuda.py``.
"""
import os
import sys

import numpy as np
import pytest
import torch

from test_torch_raster import light_direction, random_scene, run_jax_reference

from cython3dmodelrenderer_tpu_torch.config import RenderConfig
from cython3dmodelrenderer_tpu_torch.ops import binning, frontend, raster
from cython3dmodelrenderer_tpu_torch.ops.illumination import lambert_shade
from cython3dmodelrenderer_tpu_torch.ops.projection import (
    project_to_screen, projection_matrix, visibility_masks)
from cython3dmodelrenderer_tpu_torch.ops.transforms import (_matmul3,
                                                            rotation_matrix)
from cython3dmodelrenderer_tpu_torch.parallel import multiview
from cython3dmodelrenderer_tpu_torch.utils.timing import counters

TILE_H, TILE_W = raster.TILE_H, raster.TILE_W
#: (name, n_attrs, fast shade)
VARIANTS = [("geometry", 0, False), ("lean", 3, False), ("full", 6, False),
            ("fast", 3, True)]


def edge_scene():
    """Random triangles reaching past the image edges, with the cases of
    the module docstring in rows 0-5."""
    tris, colors, normals = random_scene(60, 11)
    tris[..., :2] *= 1.6
    tris[0, 1, 2] = 0.0                      # on the camera plane: w = 0
    tris[1, 2, 0] = np.nan                   # one NaN x coordinate
    tris[2, 2] = tris[2, 0]                  # degenerate: zero cross
    normals[3, :, 2] = np.abs(normals[3, :, 2]) + 0.1       # backfacing
    tris[4, :, 0] += 5.0                     # fully off-screen
    tris[5] = [[-2.0, -2.0, 1.0], [3.0, -1.0, 1.0], [0.0, 3.0, 1.0]]
    normals[[0, 1, 2, 4, 5], :, 2] = -np.abs(normals[[0, 1, 2, 4, 5], :, 2]) - 0.1
    return tris, colors, normals


def scenes():
    """(name, height, width, fov, tris, colors, normals)."""
    empty = tuple(np.zeros((0, 3, 3), np.float32) for _ in range(3))
    return [("random64", 64, 64, 60.0, *random_scene(80, 5)),
            ("edge96x128", 96, 128, 45.0, *edge_scene()),
            ("empty64", 64, 64, 60.0, *empty)]


def canonical_bits(a):
    """Bit patterns, every NaN canonical."""
    a = np.asarray(a, np.float32)
    return np.where(np.isnan(a), np.float32(np.nan), a).view(np.int32)


def port_planes(scene, n_attrs, fast, fn=frontend.frame_planes, poses=None):
    _name, h, w, fov, tris, colors, normals = scene
    return fn(torch.from_numpy(tris), torch.from_numpy(normals),
              torch.from_numpy(colors), RenderConfig(height=h, width=w, fov=fov),
              n_attrs, TILE_H, TILE_W,
              shade=light_direction() if fast else None, poses=poses)


@pytest.fixture(scope="module")
def jax_planes(tmp_path_factory):
    job = {"light": light_direction()}
    for name, h, w, fov, tris, colors, normals in scenes():
        job[f"{name}/hwf"] = np.array([h, w, fov], np.float32)
        job[f"{name}/tris"], job[f"{name}/colors"] = tris, colors
        job[f"{name}/normals"] = normals
    return run_jax_reference(os.path.abspath(__file__), job,
                             tmp_path_factory.mktemp("jax_frontend"))


@pytest.mark.parametrize("variant", VARIANTS, ids=lambda v: v[0])
@pytest.mark.parametrize("scene", scenes(), ids=lambda s: s[0])
def test_front_end_bit_equal_to_jax(jax_planes, scene, variant):
    tag, n_attrs, fast = variant
    name = scene[0]
    rows, tx0, cx, ty0, cy, counts, total = port_planes(scene, n_attrs, fast)
    t = scene[4].shape[0]
    assert rows.shape == (t, binning.row_width(n_attrs))
    assert rows.dtype == torch.float32 and total.dtype == torch.int64
    want = jax_planes
    np.testing.assert_array_equal(canonical_bits(rows.numpy()),
                                  canonical_bits(want[f"{name}/{tag}/rows"]))
    for key, got in zip(("tx0", "cx", "ty0", "cy", "counts"),
                        (tx0, cx, ty0, cy, counts)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want[f"{name}/{tag}/{key}"])
    assert int(total) == int(want[f"{name}/{tag}/counts"].sum())
    assert t == 0 or int(total) > 0


def test_edge_scene_hits_every_case(jax_planes):
    """The edge scene's special rows do what their comments say, on both
    sides: only the camera-plane, NaN, huge and ordinary triangles may
    cover pixels; the degenerate, backfacing and off-screen ones do not."""
    scene = scenes()[1]
    rows, tx0, cx, ty0, cy, counts, _total = port_planes(scene, 6, False)
    jcounts = jax_planes["edge96x128/full/counts"]
    np.testing.assert_array_equal(counts.numpy(), jcounts)
    assert counts[2] == counts[3] == counts[4] == 0
    assert counts[5] == (-(-128 // TILE_W)) * (-(-96 // TILE_H))   # clipped
    assert torch.isnan(rows[1, :12]).all()               # the NaN vertex
    assert (rows[[2, 3, 4], 12:16] == 0).all()           # empty bboxes


def old_stacked_planes(tri_verts, tri_norms, tri_colors, angles_b, shifts_b,
                       config, light=None, fast=False, lean=False):
    """The sweep's per-view front end before F1, as it was written."""
    nty = -(-config.height // TILE_H)
    parts = []
    for v in range(len(angles_b)):
        rt = rotation_matrix(np.asarray(angles_b[v], np.float32),
                             device="cpu").T
        shift = torch.as_tensor(np.asarray(shifts_b[v], np.float32))
        pv, pn = _matmul3(tri_verts, rt) + shift, _matmul3(tri_norms, rt)
        degenerate, backfacing = visibility_masks(pv, pn)
        colors, normals = tri_colors, pn
        if tri_colors is None:
            normals = None
        elif fast:
            colors, normals = lambert_shade(tri_colors, pn, light), None
        elif lean:
            normals = None
        rows, tx0, cx, ty0, cy, counts = binning.plane_data(
            project_to_screen(pv, config), ~degenerate & ~backfacing, config,
            TILE_H, TILE_W, colors=colors, normals=normals)
        parts.append((rows, tx0, cx, ty0 + v * nty, cy, counts))
    return tuple(torch.cat(xs) for xs in zip(*parts))


def posed_batch():
    tris, colors, normals = random_scene(70, 21)
    tris[..., 2] -= 1.0                       # centred, as a sweep poses it
    tris[3, 1, 0] = np.nan
    angles = np.float32([[0, 0, 0], [10, 120, -5], [0, 240, 30]])
    shifts = np.float32([[0, 0, 2], [0.1, -0.2, 2.5], [0, 0, 1.5]])
    return (*map(torch.from_numpy, (tris, normals, colors)), angles, shifts,
            RenderConfig(height=72, width=100, fov=50))


@pytest.mark.parametrize("variant", VARIANTS, ids=lambda v: v[0])
def test_posed_batch_equals_the_per_view_loop(variant):
    """V = 3 posed views in one call, bit-equal (NaN rows included) to the
    per-view loop and ``torch.cat``; ``multiview._stacked_planes`` on both
    backends gives the same."""
    tag, n_attrs, fast = variant
    tv, tn, tc, angles, shifts, config = posed_batch()
    colors = None if tag == "geometry" else tc
    light = light_direction()
    want = old_stacked_planes(tv, tn, colors, angles, shifts, config,
                              light=light, fast=fast, lean=tag == "lean")
    poses = torch.stack([multiview._pose_matrix(a, s)
                         for a, s in zip(angles, shifts)])
    got = frontend.frame_planes(tv, tn, colors, config, n_attrs, TILE_H,
                                TILE_W, shade=light if fast else None,
                                poses=poses)
    for backend in ("cuda", "torch"):
        again = multiview._stacked_planes(tv, tn, colors, angles, shifts,
                                          config, n_attrs,
                                          shade=light if fast else None,
                                          backend=backend)
        for a, b in zip(got, again):
            assert torch.equal(a.view(torch.int32) if a.is_floating_point()
                               else a, b.view(torch.int32)
                               if b.is_floating_point() else b)
    assert got[0].shape == (3 * tv.shape[0], binning.row_width(n_attrs))
    np.testing.assert_array_equal(got[0].view(torch.int32).numpy(),
                                  want[0].view(torch.int32).numpy())
    for g, w in zip(got[1:6], want[1:]):
        assert torch.equal(g, w)
    assert int(got[6]) == int(want[-1].sum()) > 0
    assert int(got[3].max()) >= 2 * (-(-72 // TILE_H))     # view 2's rows


def test_pose_triangles_is_the_old_pose():
    tv, tn, _tc, angles, shifts, _config = posed_batch()
    rt = rotation_matrix(angles[1], device="cpu").T
    pv, pn = multiview._pose_triangles(tv, tn, angles[1], shifts[1])
    assert torch.equal(pv.view(torch.int32),
                       (_matmul3(tv, rt) + torch.from_numpy(shifts[1]))
                       .view(torch.int32))
    assert torch.equal(pn.view(torch.int32), _matmul3(tn, rt).view(torch.int32))


def test_wrapper_runs_plain_on_cpu():
    """CPU tensors take the plain version and launch nothing."""
    scene = scenes()[0]
    before = counters["launch.frontend"]
    got = port_planes(scene, 6, False)
    want = port_planes(scene, 6, False, fn=frontend.frame_planes_plain)
    assert counters["launch.frontend"] == before
    for a, b in zip(got, want):
        assert torch.equal(a, b) or (a.is_floating_point()
                                     and torch.equal(a.view(torch.int32),
                                                     b.view(torch.int32)))


def test_wrapper_refuses_other_devices():
    """A tensor neither on the CPU nor on the card raises; no fallback."""
    tris, colors, normals = (torch.zeros((4, 3, 3), device="meta")
                             for _ in range(3))
    with pytest.raises(ValueError, match="unsupported device"):
        frontend.frame_planes(tris, normals, colors, RenderConfig(64, 64), 6,
                              TILE_H, TILE_W)


@pytest.mark.parametrize("n_attrs,colors,shade", [(4, True, False),
                                                  (3, False, False),
                                                  (0, True, True)])
def test_wrapper_refuses_bad_channels(n_attrs, colors, shade):
    tris, tc, tn = map(torch.from_numpy, random_scene(5, 1))
    with pytest.raises(ValueError):
        frontend.frame_planes(tris, tn, tc if colors else None,
                              RenderConfig(64, 64), n_attrs, TILE_H, TILE_W,
                              shade=light_direction() if shade else None)


@pytest.mark.parametrize("n", [0, 1, 127, 128, 129, 16128, 262144,
                               4 * 16128])
@pytest.mark.parametrize("n_attrs", [0, 3, 6])
def test_launch_plan(n, n_attrs):
    """F1's launch plan (the mirror of ``csrc/frontend.cu``'s launcher):
    sphere16k's 16,128 triangles fill at least 126 of the 132 SMs; every
    block's shared memory fits without the opt-in; the rows come in whole
    blocks whose chunks are whole 16-byte units; rows, spans and the
    8-byte-aligned total do not overlap in the one buffer."""
    plan = frontend.frontend_plan(n, n_attrs)
    width = binning.row_width(n_attrs)
    assert plan.threads == frontend.THREADS and plan.threads % 32 == 0
    assert plan.blocks == max(1, -(-n // plan.threads))
    assert plan.padded_rows == (plan.blocks if n else 0) * plan.threads >= n
    assert plan.threads * width * 4 % 16 == 0
    assert plan.smem_bytes <= frontend.SMEM_LIMIT
    assert plan.spans_at == plan.padded_rows * width
    assert plan.total_at >= plan.spans_at + 5 * n and plan.total_at % 2 == 0
    assert plan.words == plan.total_at + 2
    if n == 16128:
        assert plan.blocks >= 126


def test_smoke_counts_straddle_a_block():
    """The card's F1 checks (``chip_smoke.FRONTEND_COUNTS``) cut the edge
    scene at one, a block less one, a block, a block and one, two and one,
    and a tail of 3 rows (no whole 16-byte chunk at 25 or 34 columns)."""
    import chip_smoke

    b = frontend.THREADS
    assert chip_smoke.FRONTEND_COUNTS == (1, b - 1, b, b + 1, 2 * b + 1,
                                          2 * b + 3)
    assert all(3 * binning.row_width(a) * 4 % 16 for a in (3, 6))


def test_plan_shared_memory():
    """The staging bytes a block: rows, inputs, a pair count a warp."""
    b = frontend.THREADS
    assert [frontend.frontend_plan(1, a).smem_bytes for a in (0, 3, 6)] == [
        4 * b * (16 + 18) + b // 4, 4 * b * (25 + 27) + b // 4,
        4 * b * (34 + 27) + b // 4]


def test_projection_floats_are_cached():
    """The wrapper's 16 projection floats equal ``projection_matrix``,
    are built once per (fov, aspect, z_near, z_far) and follow ``fov``."""
    config = RenderConfig(height=96, width=128, fov=45.0)
    pm = frontend.projection_floats(config)
    np.testing.assert_array_equal(np.array(pm[:], np.float32),
                                  projection_matrix(config).ravel())
    assert frontend.projection_floats(RenderConfig(height=96, width=128,
                                                   fov=45.0)) is pm
    assert frontend.projection_floats(RenderConfig(height=192, width=256,
                                                   fov=45.0)) is pm
    other = frontend.projection_floats(RenderConfig(height=96, width=128,
                                                    fov=60.0))
    assert other is not pm and other[:] != pm[:]
    np.testing.assert_array_equal(
        np.array(other[:], np.float32),
        projection_matrix(RenderConfig(height=96, width=128, fov=60.0)).ravel())


def counting(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def wrapped(*args, **kwargs):
        calls.append(kwargs.get("poses"))
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, wrapped)
    return calls


@pytest.mark.parametrize("post", ["none", "u8", "lambert_u8",
                                  "fast_lambert_u8"])
def test_render_frame_calls_the_wrapper_once(monkeypatch, post):
    """``backend="cuda"`` frames go through ``frame_planes`` once a frame,
    ``"torch"`` frames through the plain version; both render the same."""
    tris, colors, normals = map(torch.from_numpy, random_scene(40, 2))
    config = RenderConfig(height=64, width=64, fov=60)
    calls = counting(monkeypatch, raster, "frame_planes")
    plain = counting(monkeypatch, raster, "frame_planes_plain")
    light = light_direction()
    a = raster.render_frame(tris, normals, colors, config, post=post,
                            light=light, backend="cuda")
    assert (len(calls), len(plain)) == (1, 0)
    b = raster.render_frame(tris, normals, colors, config, post=post,
                            light=light, backend="torch")
    assert (len(calls), len(plain)) == (1, 1)
    assert a[2] == b[2] > 0
    for x, y in zip(a[:2], b[:2]):
        if isinstance(x, tuple):
            assert all(torch.equal(p, q) for p, q in zip(x, y))
        else:
            assert (x is None and y is None) or torch.equal(x, y)


@pytest.mark.parametrize("view_batch", [1, 4])
def test_sweep_calls_the_wrapper_once_a_batch(monkeypatch, view_batch):
    """One ``frame_planes`` call a view batch, every view posed in it."""
    tv, tn, tc, _angles, _shifts, config = posed_batch()
    calls = counting(monkeypatch, raster, "frame_planes")
    images = multiview.render_turntable_pallas(
        tv, tn, tc, multiview.turntable_angles(8), config,
        view_batch=view_batch)
    assert images.shape == (8, 72, 100, 3)
    assert [p.shape[0] for p in calls] == [view_batch] * (8 // view_batch)


def test_sequence_demand_uses_geometry_rows(monkeypatch):
    """The demand helper asks the front end for geometry only (16-column
    rows, no colours)."""
    tv, tn, _tc, angles, shifts, config = posed_batch()
    calls = []
    fn = raster.frame_planes

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls.append(out[0].shape[1])
        return out

    monkeypatch.setattr(raster, "frame_planes", wrapped)
    p_cap, _g_cap = multiview.sequence_demand(tv, tn, angles, shifts, config,
                                              view_batch=3)
    assert calls == [binning.row_width(0)] and p_cap > 0


# ---------------------------------------------------------------------------
# JAX reference (run as a script by ``jax_planes``)
# ---------------------------------------------------------------------------

def _jax_main(job_path, out_path):
    import jax

    from cython3dmodelrenderer_tpu.config import RenderConfig as JaxConfig
    from cython3dmodelrenderer_tpu.fillers import _geometry_stage
    from cython3dmodelrenderer_tpu.ops import binning as jax_binning
    from cython3dmodelrenderer_tpu.ops.illumination import \
        lambert_shade as jax_lambert

    plane = jax.jit(jax_binning.plane_data,
                    static_argnames=("config", "tile_h", "tile_w"))
    shade = jax.jit(jax_lambert)
    out = {}
    with np.load(job_path) as job:
        light = job["light"]
        names = sorted({k.split("/")[0] for k in job.files if "/" in k})
        for name in names:
            h, w, fov = job[f"{name}/hwf"]
            config = JaxConfig(height=int(h), width=int(w), fov=float(fov))
            tv, tc, tn = (jax.numpy.asarray(job[f"{name}/{k}"])
                          for k in ("tris", "colors", "normals"))
            ts, active = _geometry_stage(tv, tn, config)
            for tag, n_attrs, fast in VARIANTS:
                colors = (None if not n_attrs
                          else shade(tc, tn, light) if fast else tc)
                res = plane(ts, active, config=config, tile_h=TILE_H,
                            tile_w=TILE_W, colors=colors,
                            normals=tn if n_attrs == 6 else None)
                for key, val in zip(("rows", "tx0", "cx", "ty0", "cy",
                                     "counts"), res):
                    out[f"{name}/{tag}/{key}"] = np.asarray(val)
    np.savez(out_path, **out)


if __name__ == "__main__":
    _jax_main(sys.argv[1], sys.argv[2])
