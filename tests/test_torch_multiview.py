"""Port sweep path (``parallel.multiview``, ``Renderer.render_sequence``,
fast shade, view-batched B1) against the JAX package.

The JAX side runs the JAX package's own sweeps and frames
(``render_turntable_pallas`` / ``render_sequence_pallas`` /
``raster_pallas.render_frame`` with ``interpret=True``) in a subprocess
(this file as a script) with FMA contraction off (``--xla_cpu_max_isa=AVX``,
see ``test_torch_raster.py``), and the port must match it bit for bit.

The pose seam: JAX builds each view's rotation matrix inside ``jit``, where
XLA:CPU evaluates sin/cos with its own polynomials, so the port's matrix
may sit an ulp away (``test_torch_scene.py``). Posed triangles are held to
JAX within 1e-6; with JAX's own matrices (saved by the subprocess) patched
into ``multiview.rotation_matrix`` they must be bit-equal, and every frame
comparison runs with that patch.

Scenes and sizes mirror ``tests/test_multiview.py`` (64², 24 triangles;
the odd sizes 72 x 100 and 100 x 130; the 70-tile-wide over-budget frame).
"""
import os
import sys

import numpy as np
import pytest
import torch

from test_torch_raster import REPO, random_scene, run_jax_reference

import cython3dmodelrenderer_tpu_torch as pt
from cython3dmodelrenderer_tpu_torch.config import RenderConfig
from cython3dmodelrenderer_tpu_torch.ops import raster
from cython3dmodelrenderer_tpu_torch.parallel import multiview

CONFIG = RenderConfig(height=64, width=64, fov=45)
ODD_SIZES = [(72, 100), (100, 130)]
WIDE = RenderConfig(height=32, width=32 * 70, fov=60)      # 70 tiles wide
LIGHTS = {"default": (0.0, 0.0, 1.0), "tilted": (0.2, 0.1, 1.0),
          "raster": (0.3, -0.2, 1.0), "skew": (1.0, -2.0, 3.0)}
SHIFTS4 = np.asarray([[0.0, 0.0, 1.0 + 0.5 * i] for i in range(4)], np.float32)


def tiny_scene(t=16, seed=0):
    """``tests/test_multiview.py::tiny_scene``, as numpy arrays."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-0.3, 0.3, size=(t, 1, 3)).astype(np.float32)
    centers[..., 2] = 0.0
    tris = centers + rng.uniform(-0.2, 0.2, size=(t, 3, 3)).astype(np.float32)
    normals = rng.randn(t, 3, 3).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    colors = rng.uniform(0, 255, size=(t, 3, 3)).astype(np.float32)
    return tris, normals, colors


def wide_scene():
    """``test_view_batched_over_budget_degrades``'s scene."""
    rng = np.random.RandomState(2)
    t = 12
    tv = (rng.rand(t, 3, 3) * 0.4 - 0.2).astype(np.float32) + np.float32([0, 0, 1.0])
    tn = np.tile(np.float32([0, 0, -1]), (t, 3, 1))
    tc = rng.rand(t, 3, 3).astype(np.float32) * 255
    return tv, tn, tc


def torch_scene(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    return run_jax_reference(os.path.abspath(__file__), {"run": np.array(1)},
                             tmp_path_factory.mktemp("jax_multiview"))


@pytest.fixture
def jax_rotations(jax_out, monkeypatch):
    """Patch JAX's own rotation matrices into the port's sweep."""
    table = {}
    for key in [k for k in jax_out if k.startswith("rot/")]:
        angle = jax_out[key.replace("rot/", "rot_angle/")]
        table[angle.astype(np.float32).tobytes()] = jax_out[key]

    def rotation_matrix(angles, degrees=True, device=None):
        assert degrees
        return torch.from_numpy(
            table[np.asarray(angles, np.float32).tobytes()]).to(device)

    monkeypatch.setattr(multiview, "rotation_matrix", rotation_matrix)
    return table


def bits(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_bit_equal(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(bits(got), bits(want))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8, 64])
def test_turntable_angles_bit_equal(jax_out, n):
    got = multiview.turntable_angles(n)
    assert got.dtype == torch.float32 and got.shape == (n, 3)
    assert_bit_equal(got, jax_out[f"angles/{n}"])


@pytest.mark.parametrize("name", sorted(LIGHTS))
def test_norm_light_bit_equal(jax_out, name):
    got = multiview._norm_light(LIGHTS[name])
    assert got.dtype == np.float32
    assert_bit_equal(got, jax_out[f"light/{name}"])
    assert multiview._norm_light(None) is None


def test_pose_triangles_match_jax(jax_out, monkeypatch):
    """Within 1e-6 with the port's own rotation matrices; bit-equal with
    JAX's (the 3-term products against XLA's einsum without FMA)."""
    tv, tn, _tc = torch_scene(*tiny_scene(24, 9))
    angles = jax_out["angles/4"]
    for i, a in enumerate(angles):
        v, n = multiview._pose_triangles(tv, tn, a, SHIFTS4[i])
        np.testing.assert_allclose(v.numpy(), jax_out[f"pose/v{i}"], rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(n.numpy(), jax_out[f"pose/n{i}"], rtol=0,
                                   atol=1e-6)
    monkeypatch.setattr(multiview, "rotation_matrix",
                        lambda ang, degrees=True, device=None: torch.from_numpy(
                            jax_out[f"pose/r{int(ang[1]) // 90}"]))
    for i, a in enumerate(angles):
        v, n = multiview._pose_triangles(tv, tn, a, SHIFTS4[i])
        assert_bit_equal(v, jax_out[f"pose/v{i}"])
        assert_bit_equal(n, jax_out[f"pose/n{i}"])


def test_render_sequence_generalizes_turntable(jax_out, jax_rotations):
    """``test_multiview.py:143``: constant shifts equal the turntable;
    varying shifts give each frame its own translation."""
    tv, tn, tc = torch_scene(*tiny_scene(24, 9))
    angles = multiview.turntable_angles(4)
    tt = multiview.render_turntable_pallas(tv, tn, tc, angles, CONFIG)
    assert_bit_equal(tt, jax_out["tt_f32"])
    const = np.broadcast_to(np.float32([0.0, 0.0, 1.0]), (4, 3))
    seq, used = multiview.render_sequence_pallas(tv, tn, tc, angles, const,
                                                 CONFIG, check_capacity=True)
    assert torch.equal(seq, tt)
    assert used == max(multiview.render_sequence_pallas(
        tv, tn, tc, angles[i:i + 1], const[i:i + 1], CONFIG,
        check_capacity=True)[1] for i in range(4)) > 0
    seq2 = multiview.render_sequence_pallas(tv, tn, tc, angles, SHIFTS4, CONFIG)
    assert_bit_equal(seq2, jax_out["seq_shift"])
    covered = [int((f.amax(-1) > 0).sum()) for f in seq2]
    assert covered[0] > covered[-1] > 0


def test_sequence_post_u8_quantizes(jax_out, jax_rotations):
    """``test_multiview.py:171``: the u8 sweep is the f32 sweep truncated."""
    tv, tn, tc = torch_scene(*tiny_scene(24, 9))
    angles = multiview.turntable_angles(3)
    f32 = multiview.render_turntable_pallas(tv, tn, tc, angles, CONFIG)
    u8 = multiview.render_turntable_pallas(tv, tn, tc, angles, CONFIG, post="u8")
    assert_bit_equal(f32, jax_out["tt3_f32"])
    assert_bit_equal(u8, jax_out["tt3_u8"])
    assert torch.equal(u8, f32.to(torch.uint8))
    sq = multiview.render_sequence_pallas(
        tv, tn, tc, angles, np.broadcast_to(np.float32([0, 0, 1]), (3, 3)),
        CONFIG, post="u8")
    assert torch.equal(sq, u8)


@pytest.mark.parametrize("vb", [2, 4])
def test_view_batched_sweep_bit_identical(jax_out, jax_rotations, vb):
    """``test_multiview.py:193``: every view of a batch is bit-identical
    to its ``view_batch=1`` render, in f32 and u8, turntable and sequence,
    and equal to the JAX sweeps."""
    tv, tn, tc = torch_scene(*tiny_scene(24, 9))
    angles = multiview.turntable_angles(4)
    got, used = multiview.render_turntable_pallas(
        tv, tn, tc, angles, CONFIG, view_batch=vb, check_capacity=True)
    assert_bit_equal(got, jax_out["tt_f32"])
    assert_bit_equal(got, jax_out["tt_f32_vb2"])
    assert used == multiview.sequence_demand(tv, tn, angles, None, CONFIG,
                                             headroom=1.0, view_batch=vb)[0]
    seq = multiview.render_sequence_pallas(tv, tn, tc, angles, SHIFTS4, CONFIG,
                                           view_batch=vb)
    assert_bit_equal(seq, jax_out["seq_shift"])
    u8 = multiview.render_turntable_pallas(tv, tn, tc, angles, CONFIG,
                                           view_batch=vb, post="u8")
    assert_bit_equal(u8, jax_out["tt_f32"].astype(np.uint8))


def test_view_batched_counting_route(jax_out, jax_rotations):
    """``test_multiview.py:253``: a view batch binned by the counting sort
    (``group=1``) renders each view's z-buffer as JAX's single-view
    un-grouped frame does."""
    tv, tn, tc = torch_scene(*tiny_scene(24, 9))
    angles = multiview.turntable_angles(2)
    shifts = np.broadcast_to(np.float32([0.0, 0.0, 1.0]), (2, 3))
    rows, tx0, cx, ty0, cy, counts = multiview._stacked_planes(
        tv, tn, tc, angles, shifts, CONFIG)
    ntx, nty = 2, 4
    bins = raster.route_bins(tx0, cx, ty0, cy, ntx, nty, int(counts.sum()),
                             group=1, backend="torch", n_views=2)
    (color, z, _n), _img = raster.raster_tiles_plain(
        rows, *bins, ntx, nty, 64, 64, 6, CONFIG.z_init, n_views=2)
    assert z.shape == (2, 64, 64, 1)
    for i in range(2):
        assert_bit_equal(z[i], jax_out[f"ungrouped_z/{i}"])


@pytest.mark.parametrize("vb", [1, 2])
def test_fast_shade_sweep(jax_out, jax_rotations, vb):
    """``test_multiview.py:283``: every fast-shade frame equals JAX's
    single-frame ``post="fast_lambert_u8"`` dispatch, per view and batched."""
    tv, tn, tc = torch_scene(*tiny_scene(24, 9))
    angles = multiview.turntable_angles(4)
    got = multiview.render_turntable_pallas(tv, tn, tc, angles, CONFIG,
                                            post="u8", fast_shade=True,
                                            view_batch=vb)
    want = np.stack([jax_out[f"fast_frame/{i}"] for i in range(4)])
    assert_bit_equal(got, want)
    f32 = multiview.render_turntable_pallas(tv, tn, tc, angles, CONFIG,
                                            fast_shade=True, view_batch=vb)
    assert torch.equal(f32.to(torch.uint8), got)
    with pytest.raises(ValueError, match="light"):
        multiview.render_turntable_pallas(tv, tn, tc, angles, CONFIG,
                                          fast_shade=True,
                                          light_direction=None)


@pytest.mark.parametrize("hw", ODD_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_view_batched_odd_image_sizes(jax_out, jax_rotations, hw):
    """``test_multiview.py:319``: partial edge tiles per view — no block
    writes past its view."""
    cfg = RenderConfig(height=hw[0], width=hw[1], fov=45)
    tv, tn, tc = torch_scene(*tiny_scene(20, 5))
    angles = multiview.turntable_angles(4)
    want = jax_out[f"odd/{hw[0]}x{hw[1]}"]
    for vb in (1, 2, 4):
        got = multiview.render_turntable_pallas(tv, tn, tc, angles, cfg,
                                                view_batch=vb)
        assert_bit_equal(got, want)


@pytest.mark.parametrize("illum", ["guro", "none"])
def test_renderer_render_sequence_wrapper(jax_out, jax_rotations, illum):
    """``test_multiview.py:338``: the Renderer wrapper equals JAX's
    ``Renderer.render_sequence`` and the functional sweep, derives its
    light from the drawer and leaves the Renderer's buffers alone."""
    tv, tn, tc = torch_scene(*tiny_scene(20, 3))

    class _M:
        vertices_by_triangles = tv
        normals_by_triangles = tn
        colors_by_triangles = tc

    shader = (pt.GuroIllumination([0.2, 0.1, 1.0]) if illum == "guro"
              else pt.NoIllumination())
    renderer = pt.Renderer(pt.AdvancedPixelBufferFiller(64, 64, fov=45,
                                                          device="cpu"),
                           shader, pt.SimpleIterator, 64, 64)
    angles = multiview.turntable_angles(3)
    for vb in (1, 3):
        got = renderer.render_sequence(_M(), angles, view_batch=vb)
        assert got.shape == (3, 64, 64, 3) and got.dtype == torch.uint8
        assert_bit_equal(got, jax_out[f"rs/{illum}"])
    assert renderer.color_buffer.get_image().max() == 0
    assert renderer.z_buffer.get_image().min() == np.float32(1e6)
    if illum == "guro":
        raw = jax_out["rs/none"]
        lit = raw.sum(-1) > 0
        assert (raw[lit].astype(int) >= got.numpy()[lit].astype(int)).mean() > 0.99


def test_renderer_render_sequence_untextured_and_fast(jax_rotations):
    """Fallback colours come from the Renderer's generator; fast shade
    equals the functional fast sweep; custom drawers are refused."""
    tris, normals, _colors = tiny_scene(20, 3)
    model = pt.Model(tris.reshape(-1, 3), np.arange(60).reshape(20, 3),
                     device="cpu")
    model_normals = model.normals_by_triangles
    angles = multiview.turntable_angles(2)

    def renderer(seed, shader=None):
        return pt.Renderer(pt.AdvancedPixelBufferFiller(64, 64, fov=45,
                                                          device="cpu"),
                           shader or pt.GuroIllumination([0, 0, 1]),
                           pt.SimpleIterator, 64, 64,
                           generator=torch.Generator().manual_seed(seed))

    a = renderer(5).render_sequence(model, angles)
    assert torch.equal(a, renderer(5).render_sequence(model, angles))
    assert not torch.equal(a, renderer(6).render_sequence(model, angles))
    colors = torch.randint(256, (20, 3), generator=torch.Generator().manual_seed(5))
    colors = colors.to(torch.float32)[:, None, :].expand(20, 3, 3)
    fast = renderer(5).render_sequence(model, angles, fast_shade=True,
                                       view_batch=2)
    want = multiview.render_turntable_pallas(
        model.vertices_by_triangles, model_normals, colors, angles, CONFIG,
        post="u8", fast_shade=True)
    assert torch.equal(fast, want) and int(fast.max()) > 0

    class Custom(pt.IlluminationDrawer):
        def apply(self, color, n_buffer):
            return color

    with pytest.raises(TypeError, match="GuroIllumination"):
        renderer(5, Custom()).render_sequence(model, angles)


@pytest.mark.parametrize("vb", [1, 2])
def test_view_batched_over_budget_degrades(jax_out, jax_rotations, monkeypatch,
                                           vb):
    """``test_multiview.py:385``: a frame 70 tiles wide is past the grouped
    budget: the batch bins through the counting sort alone and matches."""
    def no_sort_route(*args, **kwargs):
        raise AssertionError("the sort route ran past the grouped budget")

    monkeypatch.setattr(raster, "bin_pairs", no_sort_route)
    tv, tn, tc = torch_scene(*wide_scene())
    angles = multiview.turntable_angles(2)
    got = multiview.render_turntable_pallas(tv, tn, tc, angles, WIDE,
                                            view_batch=vb)
    assert_bit_equal(got, jax_out["wide_f32"])
    assert multiview.sequence_demand(tv, tn, angles, None, WIDE,
                                     view_batch=vb)[1] == 0


@pytest.mark.parametrize("size", [64, 128])
def test_fast_shade_frame_matches_jax(jax_out, size):
    """``render_frame(post="fast_lambert_u8")`` against JAX's fast frame:
    image and colour G-buffer bit-equal, z bit-equal to exact mode, the
    normal G-buffer zeros."""
    tris, colors, normals = random_scene(80, 21 + size)
    cfg = RenderConfig(height=size, width=size, fov=60)
    args = [torch.from_numpy(a) for a in (tris, normals, colors)]
    light = multiview._norm_light(LIGHTS["raster"])
    (color, z, normal), img, _n = raster.render_frame(
        *args, cfg, post="fast_lambert_u8", light=light, gbuffer=True, group=16)
    (_c, z_exact, _nn), exact_img, _n = raster.render_frame(
        *args, cfg, post="lambert_u8", light=light, gbuffer=True, group=16)
    assert_bit_equal(img, jax_out[f"ff/{size}/img"])
    assert_bit_equal(color, jax_out[f"ff/{size}/color"])
    assert_bit_equal(z, jax_out[f"ff/{size}/z_exact"])
    assert_bit_equal(z, jax_out[f"ff/{size}/z"])
    assert torch.equal(z, z_exact) and float(normal.abs().max()) == 0
    assert not torch.equal(img, exact_img) and int(img.max()) > 0


def test_filler_fast_shade(jax_out):
    """``AdvancedPixelBufferFiller(fast_shade=True)`` turns Guro frames into
    fast-shade frames; its lazy getters read that frame's own G-buffer."""
    tris, colors, normals = random_scene(80, 85)
    args = torch_scene(tris, normals, colors)
    light = pt.GuroIllumination([0.3, -0.2, 1.0]).light_direction
    filler = pt.AdvancedPixelBufferFiller(64, 64, fov=60, fast_shade=True,
                                           device="cpu")
    filler.render_arrays(*args, post="lambert_u8", light=light)
    (color, z, normal), img, _n = raster.render_frame(
        *args, RenderConfig(height=64, width=64, fov=60),
        post="fast_lambert_u8", light=light, gbuffer=True, group=16)
    assert torch.equal(filler.get_post_image(), img)
    assert torch.equal(filler.get_z_buffer(), z)
    assert torch.equal(filler.get_color_buffer(), color)
    assert float(filler.get_normals_buffer().abs().max()) == 0


def test_raster_view_batch_equals_single_views():
    """B1's plain version with a view index: one call over two stacked
    views equals a call per view, at an odd size."""
    tv, tn, tc = torch_scene(*tiny_scene(30, 7))
    cfg = RenderConfig(height=72, width=100, fov=45)
    angles = multiview.turntable_angles(2)
    shifts = np.broadcast_to(np.float32([0.0, 0.0, 1.0]), (2, 3))
    ntx, nty = 4, 5
    light = multiview._norm_light((0, 0, 1))
    stacked = multiview._stacked_planes(tv, tn, tc, angles, shifts, cfg)
    rows, tx0, cx, ty0, cy, counts = stacked
    bins = raster.route_bins(tx0, cx, ty0, cy, ntx, nty, int(counts.sum()),
                             16, "torch", n_views=2)
    gb, img = raster.raster_tiles(rows, *bins, ntx, nty, 72, 100, 6,
                                  cfg.z_init, light=light, image=True,
                                  n_views=2)
    assert img.shape == (2, 72, 100, 3) and gb[1].shape == (2, 72, 100, 1)
    for v in range(2):
        r1, tx1, cx1, ty1, cy1, c1 = multiview._stacked_planes(
            tv, tn, tc, angles[v:v + 1], shifts[v:v + 1], cfg)
        bins1 = raster.route_bins(tx1, cx1, ty1, cy1, ntx, nty,
                                  int(c1.sum()), 16, "torch")
        g1, i1 = raster.raster_tiles(r1, *bins1, ntx, nty, 72, 100, 6,
                                     cfg.z_init, light=light, image=True)
        assert torch.equal(img[v], i1)
        assert all(torch.equal(a[v], b) for a, b in zip(gb, g1))
    assert int(img.max()) > 0


def test_view_batch_must_divide_and_posts():
    tv, tn, tc = torch_scene(*tiny_scene(8, 1))
    angles = multiview.turntable_angles(3)
    with pytest.raises(ValueError, match="must divide"):
        multiview.render_turntable_pallas(tv, tn, tc, angles, CONFIG,
                                          view_batch=2)
    with pytest.raises(ValueError, match="must divide"):
        multiview.sequence_capacity(tv, tn, angles, None, CONFIG, view_batch=2)
    with pytest.raises(ValueError, match="post"):
        multiview.render_turntable_pallas(tv, tn, tc, angles, CONFIG,
                                          post="lambert_u8")
    p_cap, g_cap = multiview.sequence_demand(tv, tn, angles, None, CONFIG)
    assert multiview.turntable_capacity(tv, tn, CONFIG, n_samples=3) == p_cap
    assert p_cap > 0 and g_cap % 4 == 0 and g_cap > 0


def test_unported_multiview_functions_raise():
    for name, item in (("render_view", "item 4"), ("render_turntable", "item 4"),
                       ("render_turntable_sharded", "item 12"),
                       ("render_triangle_sharded", "item 12"),
                       ("triangle_shard_capacity", "item 12")):
        with pytest.raises(NotImplementedError, match=item):
            getattr(multiview, name)()


# ---------------------------------------------------------------------------
# JAX reference (run as a script by ``jax_out``)
# ---------------------------------------------------------------------------

def _jax_main(job_path, out_path):
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from cython3dmodelrenderer_tpu.config import RenderConfig as JConfig
    from cython3dmodelrenderer_tpu.fillers import AdvancedPixelBufferFiller
    from cython3dmodelrenderer_tpu.models.iterators import SimpleIterator
    from cython3dmodelrenderer_tpu.ops import binning, raster_pallas as rp
    from cython3dmodelrenderer_tpu.ops.illumination import (GuroIllumination,
                                                            NoIllumination)
    from cython3dmodelrenderer_tpu.ops.projection import (project_to_screen,
                                                          visibility_masks)
    from cython3dmodelrenderer_tpu.ops.transforms import rotation_matrix
    from cython3dmodelrenderer_tpu.parallel import multiview as mv
    from cython3dmodelrenderer_tpu.renderer import Renderer

    del job_path
    cfg = JConfig(height=64, width=64, fov=45)
    out = {}
    for n in (1, 2, 3, 4, 8, 64):
        out[f"angles/{n}"] = mv.turntable_angles(n)
    # the rotation matrices as the sweeps build them: inside jit, from a
    # traced angle triple
    rot = jax.jit(rotation_matrix)
    for a in np.concatenate([np.asarray(mv.turntable_angles(n))
                             for n in (2, 3, 4)]):
        key = a.tobytes().hex()
        out[f"rot/{key}"], out[f"rot_angle/{key}"] = rot(jnp.asarray(a)), a
    norm_light = jax.jit(mv._norm_light)
    for name, ld in LIGHTS.items():
        out[f"light/{name}"] = norm_light(jnp.asarray(ld, jnp.float32))

    tv, tn, tc = (jnp.asarray(a) for a in tiny_scene(24, 9))
    a4, a3, a2 = (mv.turntable_angles(n) for n in (4, 3, 2))
    shifts4 = jnp.asarray(SHIFTS4)
    pose = jax.jit(mv._pose_triangles)
    for i in range(4):
        out[f"pose/v{i}"], out[f"pose/n{i}"] = pose(tv, tn, a4[i], shifts4[i])
        out[f"pose/r{i}"] = rot(a4[i])

    cap = mv.sequence_capacity(tv, tn, a4, None, cfg)
    out["tt_f32"] = mv.render_turntable_pallas(tv, tn, tc, a4, cfg, p_cap=cap,
                                               interpret=True)
    cap2 = mv.sequence_capacity(tv, tn, a4, None, cfg, view_batch=2)
    out["tt_f32_vb2"] = mv.render_turntable_pallas(
        tv, tn, tc, a4, cfg, p_cap=cap2, interpret=True, view_batch=2)
    cap_s = mv.sequence_capacity(tv, tn, a4, shifts4, cfg)
    out["seq_shift"] = mv.render_sequence_pallas(tv, tn, tc, a4, shifts4, cfg,
                                                 p_cap=cap_s, interpret=True)
    cap3 = mv.sequence_capacity(tv, tn, a3, None, cfg)
    out["tt3_f32"] = mv.render_turntable_pallas(tv, tn, tc, a3, cfg,
                                                p_cap=cap3, interpret=True)
    out["tt3_u8"] = mv.render_turntable_pallas(tv, tn, tc, a3, cfg, p_cap=cap3,
                                               interpret=True, post="u8")

    light = mv._norm_light((0.0, 0.0, 1.0))
    const = jnp.broadcast_to(jnp.float32([0.0, 0.0, 1.0]), (4, 3))
    for i in range(4):
        pv, pn = pose(tv, tn, a4[i], const[i])
        out[f"fast_frame/{i}"] = rp.render_frame(
            pv, pn, tc, cfg, cap, 0, group=rp.GROUP, interpret=True,
            post="fast_lambert_u8", light=light)[-1]
    cap_1 = binning.capacity_bucket(4096, 128)
    for i in range(2):
        pv, pn = pose(tv, tn, a2[i], const[i])
        out[f"ungrouped_z/{i}"] = mv._render_view_pallas(
            pv, pn, tc, cfg, cap_1, 128, 1, True, light)[1]

    otv, otn, otc = (jnp.asarray(a) for a in tiny_scene(20, 5))
    for h, w in ODD_SIZES:
        ocfg = JConfig(height=h, width=w, fov=45)
        ocap = mv.sequence_capacity(otv, otn, a4, None, ocfg)
        out[f"odd/{h}x{w}"] = mv.render_turntable_pallas(
            otv, otn, otc, a4, ocfg, p_cap=ocap, interpret=True)

    rtv, rtn, rtc = (jnp.asarray(a) for a in tiny_scene(20, 3))

    class _M:
        vertices_by_triangles = rtv
        normals_by_triangles = rtn
        colors_by_triangles = rtc

    for name, illum in (("guro", GuroIllumination([0.2, 0.1, 1.0])),
                        ("none", NoIllumination())):
        renderer = Renderer(AdvancedPixelBufferFiller(
            64, 64, fov=45, backend="pallas", interpret=True), illum,
            SimpleIterator, image_height=64, image_width=64, use_tqdm=False)
        out[f"rs/{name}"] = renderer.render_sequence(_M(), a3)

    wtv, wtn, wtc = (jnp.asarray(a) for a in wide_scene())
    wcfg = JConfig(height=WIDE.height, width=WIDE.width, fov=WIDE.fov)
    wcap = mv.sequence_capacity(wtv, wtn, a2, None, wcfg)
    out["wide_f32"] = mv.render_turntable_pallas(wtv, wtn, wtc, a2, wcfg,
                                                 p_cap=wcap, interpret=True)

    flight = out["light/raster"]
    for size in (64, 128):
        tris, colors, normals = random_scene(80, 21 + size)
        fcfg = JConfig(height=size, width=size, fov=60)
        ftv, ftn, ftc = (jnp.asarray(a) for a in (tris, normals, colors))
        deg, back = visibility_masks(ftv, ftn)
        slots = int(rp.grouped_slot_total(project_to_screen(ftv, fcfg),
                                          ~deg & ~back, fcfg, group=16))
        fcap = binning.capacity_bucket(slots, 128)
        (color, z, _n), _cap, _act, img = rp.render_frame(
            ftv, ftn, ftc, fcfg, fcap, 0, group=16, interpret=True,
            post="fast_lambert_u8", light=flight)
        (_c, z_exact, _n), *_rest = rp.render_frame(
            ftv, ftn, ftc, fcfg, fcap, 0, group=16, interpret=True,
            post="lambert_u8", light=flight)
        out.update({f"ff/{size}/img": img, f"ff/{size}/color": color,
                    f"ff/{size}/z": z, f"ff/{size}/z_exact": z_exact})
    np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})


if __name__ == "__main__":
    _jax_main(sys.argv[1], sys.argv[2])
