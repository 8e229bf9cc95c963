"""Port ratio-form rasterizer (``ops/raster_ref.py``) against the JAX oracle.

The JAX side is ``cython3dmodelrenderer_tpu/ops/raster_ref.py`` — the
``backend="jnp"`` rasterizer — run in a subprocess (this file as a script)
with FMA contraction off (``--xla_cpu_max_isa=AVX``, see
``test_torch_raster.py``), so the port must match it BIT FOR BIT on the
scenes of ``tests/test_raster.py`` and ``tests/test_edge_cases.py``:
``required_bbox_size``, then the colour, z and normal G-buffers. The
subprocess also returns its inputs (the cube's posed arrays), so both sides
rasterize the same numbers.

Also here: ``barycentric`` on random points, a hand-made pixel where a
-0.0 and a +0.0 fragment meet (XLA's scatter-min keeps -0.0 within a
chunk, the earlier chunk across chunks), and the port's NumPy
``utils/oracle.py`` against the JAX package's.
"""
import os
import sys

import numpy as np
import pytest
import torch

from test_torch_raster import REPO, random_scene, run_jax_reference

from cython3dmodelrenderer_tpu_torch.config import RenderConfig
from cython3dmodelrenderer_tpu_torch.ops import raster_ref
from cython3dmodelrenderer_tpu_torch.ops.projection import (project_to_screen,
                                                            visibility_masks)
from cython3dmodelrenderer_tpu_torch.utils import oracle


def _flat(z, normal=(0.0, 0.0, -1.0), color=200.0, verts=None):
    verts = verts or [[-0.5, -0.5, z], [0.5, -0.5, z], [0.0, 0.5, z]]
    tris = np.array([verts], np.float32)
    return (tris, np.full((1, 3, 3), color, np.float32),
            np.full((1, 3, 3), normal, np.float32))


def _two_depths():
    near = [[-0.5, -0.5, 0.8], [0.5, -0.5, 0.8], [0.0, 0.5, 0.8]]
    far = [[-0.5, -0.5, 1.5], [0.5, -0.5, 1.5], [0.0, 0.5, 1.5]]
    colors = np.zeros((2, 3, 3), np.float32)
    colors[0], colors[1] = 50.0, 250.0
    return (np.array([far, near], np.float32), colors,
            np.full((2, 3, 3), [0, 0, -1], np.float32))


def _permuted(t, seed):
    tris, colors, normals = random_scene(t, seed)
    perm = np.random.RandomState(0).permutation(t)
    return tris[perm], colors[perm], normals[perm]


def _with_signed_zero_attributes():
    """Attribute products of -0.0: the 3-term sums must keep their sign."""
    tris, colors, normals = random_scene(60, 6)
    colors[:10] = -0.0
    normals[:10, :, 0] = -0.0
    return tris, colors, normals


def scenes():
    """(name, height, width, fov, chunk, (tris, colors, normals) or None for
    the cube, whose posed arrays come from the JAX side)."""
    edge = dict(
        edge_single=_flat(1.0, color=128.0,
                          verts=[[-0.3, -0.3, 1.0], [0.3, -0.3, 1.0],
                                 [0.0, 0.3, 1.0]]),
        edge_backfacing=_flat(1.0, normal=(0, 0, 1), color=128.0,
                              verts=[[-0.3, -0.3, 1.0], [0.3, -0.3, 1.0],
                                     [0.0, 0.3, 1.0]]),
        edge_behind_camera=_flat(-2.0, color=128.0,
                                 verts=[[-0.3, -0.3, -2.0], [0.3, -0.3, -2.0],
                                        [0.0, 0.3, -2.0]]),
        edge_screen_filling=_flat(1.0, color=99.0,
                                  verts=[[-50.0, -50.0, 1.0], [50.0, -50.0, 1.0],
                                         [0.0, 80.0, 1.0]]),
        edge_camera_plane=_flat(1.0, color=128.0,
                                verts=[[-0.3, -0.3, 0.0], [0.3, -0.3, 1.0],
                                       [0.0, 0.3, 1.0]]),
    )
    return [
        ("single", 64, 64, 90.0, 16, _flat(1.0)),
        ("backface", 32, 32, 90.0, 16, _flat(1.0, normal=(0, 0, 1))),
        ("degenerate", 32, 32, 90.0, 16,
         _flat(1.0, verts=[[0.0, 0.0, 1.0], [0.1, 0.0, 1.0], [0.2, 0.0, 1.0]])),
        ("z_range", 32, 32, 90.0, 16, _flat(-1.0)),
        ("two_depths", 64, 64, 90.0, 16, _two_depths()),
        ("random96x128", 96, 128, 60.0, 16, random_scene(60, 1)),
        ("order_a", 64, 64, 60.0, 16, random_scene(30, 2)),
        ("order_b", 64, 64, 60.0, 16, _permuted(30, 2)),
        ("determinism", 64, 64, 60.0, 16, random_scene(30, 4)),
        ("signed_zero_attrs", 64, 64, 60.0, 512, _with_signed_zero_attributes()),
        ("cube", 128, 128, 45.0, 16, None),
    ] + [(name, 64, 64, 60.0, 8, arrays) for name, arrays in edge.items()]


def zero_tie_screens():
    """Screen-space triangles (x, y, depth) over one window: triangle i has
    depth ``signs[i] * 0.0`` at all three vertices, so its fragments are
    -0.0 or +0.0; ``chunk`` 8 puts them in one scan step, 1 in separate
    steps."""
    base = np.array([[2.0, 2.0, 0.0], [14.0, 3.0, 0.0], [6.0, 14.0, 0.0]],
                    np.float32)
    cases = {}
    for signs in ((1, -1), (-1, 1), (1, -1, 1), (-1, 1, -1)):
        tris = np.stack([base] * len(signs))
        for i, s in enumerate(signs):
            tris[i, :, 2] = s * 0.0
        colors = np.stack([np.full((3, 3), 10.0 * (i + 1), np.float32)
                           for i in range(len(signs))])
        normals = np.full((len(signs), 3, 3), -1.0, np.float32)
        for chunk in (8, 1):
            name = "".join("+" if s > 0 else "-" for s in signs)
            cases[f"{name}/{chunk}"] = (signs, chunk, tris, colors, normals)
    return cases


def barycentric_points():
    rng = np.random.RandomState(11)
    tris = rng.uniform(-20, 80, (200, 3, 2)).astype(np.float32)
    px = rng.uniform(-20, 80, (200,)).astype(np.float32)
    py = rng.uniform(-20, 80, (200,)).astype(np.float32)
    tris[0, 1] = tris[0, 0]                  # a degenerate triangle: 0 / 0
    return tris, px, py


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    return run_jax_reference(os.path.abspath(__file__), {"run": np.array(1)},
                             tmp_path_factory.mktemp("jax_raster_ref"))


def bits(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def same_bits(got, want):
    """Bit equality: -0.0 is not +0.0, a NaN equals only its own bits."""
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(bits(got), bits(want))


def port_raster(h, w, fov, chunk, tris, colors, normals):
    config = RenderConfig(height=h, width=w, fov=fov)
    tv, tc, tn = (torch.from_numpy(np.ascontiguousarray(a))
                  for a in (tris, colors, normals))
    degenerate, backfacing = visibility_masks(tv, tn)
    active = ~degenerate & ~backfacing
    ts = project_to_screen(tv, config)
    bbox = raster_ref.required_bbox_size(ts, active, config)
    return bbox, raster_ref.rasterize(ts, tc, tn, active, config,
                                      bbox_size=bbox, chunk=chunk)


PASSES = pytest.mark.parametrize(
    "budget", [raster_ref.FRAGMENTS_PER_PASS, 1],
    ids=["passes_by_budget", "pass_per_chunk"])


@PASSES
@pytest.mark.parametrize("scene", scenes(), ids=lambda s: s[0])
def test_rasterize_bit_equal(jax_out, scene, budget, monkeypatch):
    monkeypatch.setattr(raster_ref, "FRAGMENTS_PER_PASS", budget)
    name, h, w, fov, chunk, arrays = scene
    if arrays is None:
        arrays = tuple(jax_out[f"{name}/{k}"] for k in ("tris", "colors",
                                                       "normals"))
    bbox, (color, z, normal) = port_raster(h, w, fov, chunk, *arrays)
    assert bbox == int(jax_out[f"{name}/bbox"])
    same_bits(z, jax_out[f"{name}/z"])
    same_bits(color, jax_out[f"{name}/color"])
    same_bits(normal, jax_out[f"{name}/normal"])
    assert z.shape == (h, w, 1) and color.shape == normal.shape == (h, w, 3)
    assert torch.isfinite(z).all()


def test_scenes_cover_what_they_claim(jax_out):
    """The scenes exercise what their tests assert in JAX: covered pixels,
    culled triangles, the nearer triangle winning, a full-screen fill, a
    depth order that does not depend on triangle order, and -0.0 sums."""
    got = {}
    for name, h, w, fov, chunk, arrays in scenes():
        if arrays is None:
            arrays = tuple(jax_out[f"{name}/{k}"] for k in ("tris", "colors",
                                                           "normals"))
        got[name] = port_raster(h, w, fov, chunk, *arrays)[1]
    for name in ("backface", "degenerate", "z_range", "edge_backfacing",
                 "edge_behind_camera"):
        assert float(got[name][0].abs().max()) == 0, name
        assert float(got[name][1].min()) == 1e6, name
    for name in ("single", "cube", "random96x128", "edge_single"):
        assert float(got[name][0].max()) > 0, name
    assert abs(float(got["two_depths"][0][32, 32, 0]) - 250.0) < 0.5
    assert (torch.abs(got["edge_screen_filling"][0] - 99.0) < 0.01).all()
    assert torch.equal(got["order_a"][1], got["order_b"][1])
    color, z, normal = got["signed_zero_attrs"]
    lit = z[..., 0] < 1.0
    for attr in (color, normal):
        neg_zero = torch.signbit(attr) & (attr == 0) & lit[..., None]
        assert int(neg_zero.sum()) > 0


@PASSES
def test_window_cuts_large_bboxes(jax_out, budget, monkeypatch):
    """A ``bbox_size`` under the scene's bboxes (JAX ``render_view``'s fixed
    64): each triangle is cut at the window from its bbox corner, as JAX
    cuts it."""
    monkeypatch.setattr(raster_ref, "FRAGMENTS_PER_PASS", budget)
    tris, colors, normals = random_scene(60, 1)
    config = RenderConfig(height=96, width=128, fov=60)
    tv, tc, tn = (torch.from_numpy(a) for a in (tris, colors, normals))
    degenerate, backfacing = visibility_masks(tv, tn)
    active = ~degenerate & ~backfacing
    ts = project_to_screen(tv, config)
    assert raster_ref.required_bbox_size(ts, active, config) > 32
    got = raster_ref.rasterize(ts, tc, tn, active, config, bbox_size=32,
                               chunk=16)
    for part, a in zip(("color", "z", "normal"), got):
        same_bits(a, jax_out[f"cut/{part}"])


@PASSES
@pytest.mark.parametrize("case", sorted(zero_tie_screens()))
def test_signed_zero_depth_ties(jax_out, case, budget, monkeypatch):
    """-0.0 and +0.0 fragments at one pixel: the z-buffer holds XLA's bits
    (-0.0 wins within a scan step; across steps the earlier step keeps
    its zero), the colour is the lowest triangle's; in one pass or a pass
    a chunk."""
    monkeypatch.setattr(raster_ref, "FRAGMENTS_PER_PASS", budget)
    signs, chunk, tris, colors, normals = zero_tie_screens()[case]
    config = RenderConfig(height=16, width=16)
    color, z, normal = raster_ref.rasterize(
        torch.from_numpy(tris), torch.from_numpy(colors),
        torch.from_numpy(normals), torch.ones(len(tris), dtype=torch.bool),
        config, bbox_size=16, chunk=chunk)
    same_bits(z, jax_out[f"zero/{case}/z"])
    same_bits(color, jax_out[f"zero/{case}/color"])
    same_bits(normal, jax_out[f"zero/{case}/normal"])
    covered = z[..., 0] < 1.0
    assert int(covered.sum()) > 50
    neg = torch.signbit(z[covered]).float().mean()
    if chunk == 8 or signs[0] < 0:
        assert neg > 0.9                 # -0.0 is kept
    else:
        assert neg == 0                  # the earlier step's +0.0 is kept
    assert (torch.abs(color[covered] - 10.0) < 1e-3).all()   # triangle 0


def test_barycentric_bit_equal(jax_out):
    tris, px, py = barycentric_points()
    got = raster_ref.barycentric(torch.from_numpy(tris), torch.from_numpy(px),
                                 torch.from_numpy(py))
    for k, lam in enumerate(got):
        same_bits(lam, jax_out[f"bary/{k}"])
    assert not torch.isfinite(got[0][0])                # the degenerate one


def test_required_bbox_size():
    config = RenderConfig(height=64, width=64)
    ts = torch.tensor([[[1.5, 2.0, 0.5], [40.2, 3.0, 0.5], [10.0, 9.0, 0.5]],
                       [[0.0, 0.0, 0.5], [70.0, 0.0, 0.5], [0.0, 70.0, 0.5]]])
    assert raster_ref.required_bbox_size(ts, torch.tensor([True, False]),
                                         config) == 64      # ceil: 2..41
    assert raster_ref.required_bbox_size(ts, torch.tensor([True, True]),
                                         config) == 64      # clipped at 64
    assert raster_ref.required_bbox_size(ts[:1], torch.tensor([True]), config,
                                         bucket=16) == 48
    assert raster_ref.required_bbox_size(ts[:0], torch.zeros(0, dtype=torch.bool),
                                         config) == 32
    assert raster_ref.required_bbox_size(ts, torch.tensor([False, False]),
                                         config) == 32


def test_oracle_matches_jax_oracle(jax_out):
    """The port's NumPy oracle copy equals the JAX package's, bit for bit,
    and the ratio rasterizer lies within ``tests/test_raster.py``'s bounds
    of it."""
    tris, colors, normals = random_scene(60, 1)
    config = RenderConfig(height=96, width=128, fov=60)
    want = oracle.render_oracle(tris, colors, normals, config)
    for k, part in enumerate(("color", "z", "normal")):
        same_bits(want[k], jax_out[f"oracle/{part}"])
    same_bits(oracle.lambert_np(want[0], want[2], (0.3, -0.2, 1.0)),
              jax_out["oracle/lambert"])
    _bbox, got = port_raster(96, 128, 60.0, 16, tris, colors, normals)
    np.testing.assert_allclose(got[1].numpy(), want[1], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=1e-4, atol=0.05)
    np.testing.assert_allclose(got[2].numpy(), want[2], rtol=1e-4, atol=1e-4)


def test_empty_scene_is_background():
    config = RenderConfig(height=8, width=12)
    empty = torch.zeros((0, 3, 3))
    color, z, normal = raster_ref.rasterize(empty, empty, empty,
                                            torch.zeros(0, dtype=torch.bool),
                                            config)
    assert float(z.min()) == 1e6 == float(z.max())
    assert float(color.abs().max()) == 0 == float(normal.abs().max())


# ---------------------------------------------------------------------------
# JAX reference (run as a script by ``jax_out``)
# ---------------------------------------------------------------------------

def _jax_main(job_path, out_path):
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from cython3dmodelrenderer_tpu.config import RenderConfig as JConfig
    from cython3dmodelrenderer_tpu.models.model import Model, fit_model
    from cython3dmodelrenderer_tpu.ops import raster_ref as jr
    from cython3dmodelrenderer_tpu.ops.projection import (
        project_to_screen as jproject, visibility_masks as jmasks)
    from cython3dmodelrenderer_tpu.utils import oracle as joracle

    del job_path
    out = {}
    for name, h, w, fov, chunk, arrays in scenes():
        if arrays is None:                       # test_raster.py's cube
            model = Model.read_model(os.path.join(REPO, "assets", "cube.obj"))
            model.rotate([30, 40, 0])
            fit_model(model)
            rng = np.random.RandomState(7)
            arrays = (np.asarray(model.vertices_by_triangles),
                      np.repeat(rng.uniform(0, 255, (12, 1, 3)), 3,
                                axis=1).astype(np.float32),
                      np.asarray(model.normals_by_triangles))
            for k, a in zip(("tris", "colors", "normals"), arrays):
                out[f"{name}/{k}"] = a
        config = JConfig(height=h, width=w, fov=fov)
        tv, tc, tn = (jnp.asarray(a) for a in arrays)
        degenerate, backfacing = jmasks(tv, tn)
        active = ~degenerate & ~backfacing
        ts = jproject(tv, config)
        bbox = jr.required_bbox_size(ts, active, config)
        out[f"{name}/bbox"] = np.array(bbox)
        (out[f"{name}/color"], out[f"{name}/z"],
         out[f"{name}/normal"]) = jr.rasterize(ts, tc, tn, active, config,
                                               bbox_size=bbox, chunk=chunk)
    tris, colors, normals = random_scene(60, 1)
    config = JConfig(height=96, width=128, fov=60)
    tv, tc, tn = (jnp.asarray(a) for a in (tris, colors, normals))
    degenerate, backfacing = jmasks(tv, tn)
    res = jr.rasterize(jproject(tv, config), tc, tn, ~degenerate & ~backfacing,
                       config, bbox_size=32, chunk=16)
    for part, a in zip(("color", "z", "normal"), res):
        out[f"cut/{part}"] = a
    config = JConfig(height=16, width=16)
    for case, (_s, chunk, tris, colors, normals) in zero_tie_screens().items():
        res = jr.rasterize(jnp.asarray(tris), jnp.asarray(colors),
                           jnp.asarray(normals), jnp.ones(len(tris), bool),
                           config, bbox_size=16, chunk=chunk)
        for part, a in zip(("color", "z", "normal"), res):
            out[f"zero/{case}/{part}"] = a
    tris, px, py = barycentric_points()
    lams = jax.jit(jr.barycentric)(jnp.asarray(tris), jnp.asarray(px),
                                   jnp.asarray(py))
    for k, lam in enumerate(lams):
        out[f"bary/{k}"] = lam
    tris, colors, normals = random_scene(60, 1)
    res = joracle.render_oracle(tris, colors, normals,
                                JConfig(height=96, width=128, fov=60))
    for part, a in zip(("color", "z", "normal"), res):
        out[f"oracle/{part}"] = a
    out["oracle/lambert"] = joracle.lambert_np(res[0], res[2], (0.3, -0.2, 1.0))
    np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})


if __name__ == "__main__":
    _jax_main(sys.argv[1], sys.argv[2])
