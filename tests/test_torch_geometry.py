"""Port geometry stage against JAX: projection, culling masks, plane rows.

The JAX functions run op by op here (not under ``jit``), so XLA compiles
each operation alone and contracts no multiply-add into an FMA: both sides
then evaluate the same float32 operations in the same order, and every
output must be BIT-equal.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cython3dmodelrenderer_tpu.config import RenderConfig as JaxConfig
from cython3dmodelrenderer_tpu.ops import binning as jax_binning
from cython3dmodelrenderer_tpu.ops import projection as jax_projection
from cython3dmodelrenderer_tpu.ops import raster_ref as jax_raster_ref

from cython3dmodelrenderer_tpu_torch.config import RenderConfig
from cython3dmodelrenderer_tpu_torch.models.obj_io import load_obj
from cython3dmodelrenderer_tpu_torch.ops import binning, projection, raster_ref
from test_torch_raster import random_scene

VIEWS = [(64, 64, 60.0), (96, 128, 45.0), (70, 100, 90.0)]


def scene(kind, igor_sphere_path):
    if kind == "igor":
        data = load_obj(igor_sphere_path)
        tris = data.vertices[data.faces_v] * 0.7
        tris[..., 2] += 2.0
        rng = np.random.RandomState(1)
        normals = rng.randn(*tris.shape).astype(np.float32)
        colors = rng.uniform(0, 255, tris.shape).astype(np.float32)
        return tris.astype(np.float32), colors, normals
    tris, colors, normals = random_scene(80, 5)
    if kind == "edge":          # degenerate, on-camera-plane and offscreen
        tris[0, 2] = tris[0, 0]
        tris[1, :, 2] = 0.0
        tris[2] += 5.0
    return tris, colors, normals


def bits(a):
    """Bit patterns, with every NaN canonical: IEEE leaves the sign and
    payload of a NaN an operation produces unspecified."""
    a = np.asarray(a, np.float32)
    return np.where(np.isnan(a), np.float32(np.nan), a).view(np.int32)


@pytest.mark.parametrize("kind", ["random", "edge", "igor"])
@pytest.mark.parametrize("view", VIEWS, ids=str)
def test_projection_and_planes_bit_equal(kind, view, igor_sphere_path):
    h, w, fov = view
    tris, colors, normals = scene(kind, igor_sphere_path)
    jcfg, cfg = JaxConfig(height=h, width=w, fov=fov), \
        RenderConfig(height=h, width=w, fov=fov)
    tv, tn, tc = map(jnp.asarray, (tris, normals, colors))
    pv, pn, pc = map(torch.from_numpy, (tris, normals, colors))

    jdeg, jback = jax_projection.visibility_masks(tv, tn)
    deg, back = projection.visibility_masks(pv, pn)
    np.testing.assert_array_equal(deg.numpy(), np.asarray(jdeg))
    np.testing.assert_array_equal(back.numpy(), np.asarray(jback))

    jts = jax_projection.project_to_screen(tv, jcfg)
    ts = projection.project_to_screen(pv, cfg)
    np.testing.assert_array_equal(bits(ts.numpy()), bits(jts))
    np.testing.assert_array_equal(projection.projection_matrix(cfg),
                                  np.asarray(jax_projection.projection_matrix(jcfg)))

    jact = ~jdeg & ~jback
    act = ~deg & ~back
    for jargs, args in (((tc, tn), (pc, pn)), ((tc, None), (pc, None))):
        want = jax_binning.plane_data(jts, jact, jcfg, 16, 32, colors=jargs[0],
                                      normals=jargs[1])
        got = binning.plane_data(ts, act, cfg, 16, 32, colors=args[0],
                                 normals=args[1])
        assert got[0].shape[1] == binning.row_width(6 if args[1] is not None
                                                    else 3)
        # rows bit-equal, NaN coefficients of degenerate rows included
        np.testing.assert_array_equal(bits(got[0].numpy()), bits(want[0]))
        for g, wnt in zip(got[1:], want[1:]):                # spans, counts
            np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))


def test_bbox_ceil_matches_jax():
    rng = np.random.RandomState(2)
    xy = rng.uniform(-20, 120, (200, 3, 2)).astype(np.float32)
    xy[0, 1, 0] = np.nan
    xy[1, :, 1] = np.inf
    want = jax_raster_ref.bbox_ceil(jnp.asarray(xy), 100, 70)
    got = raster_ref.bbox_ceil(torch.from_numpy(xy), 100, 70)
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))


def test_culled_rows_have_empty_bbox():
    """SAFETY INVARIANT (binning.py:92-101): inactive rows never cover."""
    tris, colors, normals = random_scene(30, 7)
    cfg = RenderConfig(height=64, width=64, fov=60)
    ts = projection.project_to_screen(torch.from_numpy(tris), cfg)
    active = torch.zeros(30, dtype=torch.bool)
    active[::2] = True
    rows, tx0, cx, ty0, cy, counts = binning.plane_data(
        ts, active, cfg, 16, 32, colors=torch.from_numpy(colors))
    culled = ~active.numpy()
    assert np.all(rows[culled, 12:16].numpy() == 0)
    assert np.all(counts.numpy()[culled] == 0)
    assert counts.numpy()[~culled].sum() > 0
