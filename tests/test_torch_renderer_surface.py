"""Port filler and Renderer surface against the JAX package: the ``"ratio"``
backend, the filler's stats and snapshot, custom illumination drawers,
``draw_illumination`` and the per-triangle compat path.

The JAX side (this file as a script) runs in a subprocess with FMA
contraction off (``--xla_cpu_max_isa=AVX``, see ``test_torch_raster.py``)
and hands over its posed igor_sphere and cube arrays, which the port loads
with ``Model.from_state``; every comparison is then BIT FOR BIT:

* ``backend="ratio"`` frames against JAX ``backend="jnp"``: posts
  ``"none"``, ``"u8"`` and ``"lambert_u8"``, the G-buffers, and the
  Renderer's images and lazy z / normal buffers;
* a custom drawer through ``Renderer.render`` on the ratio and the plain
  kernel backends (JAX: jnp and interpret-mode Pallas);
* ``draw_illumination`` in its ``Buffer`` and raw-array forms;
* ``compute_triangle_statistics`` on the cube at 64² and on 250
  igor_sphere triangles (every 24th) at 128² (JAX
  ``test_per_triangle_compat_path``), and the per-triangle Renderer loop
  with ``DepthIterator``.
"""
import os
import sys

import numpy as np
import pytest
import torch

from test_torch_raster import REPO, run_jax_reference

import cython3dmodelrenderer_tpu_torch as pt
from cython3dmodelrenderer_tpu_torch import fillers

SIZE = 96
FOV = 45
CUSTOM_SIZE = 64
COMPAT_N = 250
COMPAT_SIZE = 128
LOOP_SIZE = 48
STATE_KEYS = ("vertices", "faces_v", "normals", "faces_n", "colors", "faces_vt")
STATS_KEYS = ("pairs", "active_tiles", "pair_capacity", "live_group_capacity")


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    return run_jax_reference(os.path.abspath(__file__), {"run": np.array(1)},
                             tmp_path_factory.mktemp("jax_surface"))


def bits(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def same_bits(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(bits(got), bits(want))


def sphere(out):
    return pt.Model.from_state({k: out[f"sphere/{k}"] for k in STATE_KEYS},
                               device="cpu")


def arrays(model):
    return (model.vertices_by_triangles, model.normals_by_triangles,
            model.colors_by_triangles)


def light():
    return pt.GuroIllumination([0, 0, 1]).light_direction


def make_custom(pkg):
    """A drawer with its own ``apply``: half the colour plus a normal term
    (elementwise, so both packages round alike)."""
    class Tint(pkg.IlluminationDrawer):
        def apply(self, color, n_buffer):
            return color * 0.5 + abs(n_buffer[..., 2:3]) * 100.0

    return Tint()


def make_per_triangle(pkg, inner):
    """A filler outside the batched hierarchy: the Renderer's per-triangle
    loop drives it, and it rasterizes through ``inner``'s compat path."""
    class PerTriangle(pkg.PixelBufferFiller):
        def compute_triangle_statistics(self, *args):
            inner.compute_triangle_statistics(*args)

    return PerTriangle()


@pytest.mark.parametrize("post", ["none", "u8", "lambert_u8"])
def test_ratio_frames_match_jnp(jax_out, post):
    filler = pt.AdvancedPixelBufferFiller(SIZE, SIZE, fov=FOV, backend="ratio",
                                          device="cpu", fast_shade=True)
    filler.render_arrays(*arrays(sphere(jax_out)), post=post,
                         light=light() if post == "lambert_u8" else None)
    color, z, normal, img = filler.snapshot_buffers()
    same_bits(color, jax_out[f"jnp/{post}/color"])
    same_bits(z, jax_out[f"jnp/{post}/z"])
    same_bits(normal, jax_out[f"jnp/{post}/normal"])
    if post == "none":
        assert img is None
    else:                      # fast shade applies to the kernel backends only
        same_bits(img, jax_out[f"jnp/{post}/image"])
        assert torch.equal(filler.get_post_image(), img)
    assert torch.equal(filler.get_z_buffer(), z)
    assert torch.equal(filler.get_color_buffer(), color)
    assert torch.equal(filler.get_normals_buffer(), normal)
    assert float(z.min()) < 1.0


@pytest.mark.parametrize("illum", ["guro", "none"])
def test_ratio_renderer_matches_jnp(jax_out, illum):
    shader = pt.GuroIllumination([0, 0, 1]) if illum == "guro" else pt.NoIllumination()
    filler = pt.AdvancedPixelBufferFiller(SIZE, SIZE, fov=FOV, backend="ratio",
                                          device="cpu")
    renderer = pt.Renderer(filler, shader, pt.SimpleIterator, SIZE, SIZE)
    image = renderer.render(sphere(jax_out)).get_image()
    np.testing.assert_array_equal(image, jax_out[f"jnp_renderer/{illum}/image"])
    same_bits(renderer.z_buffer.get_image(), jax_out[f"jnp_renderer/{illum}/z"])
    same_bits(renderer.n_buffer.get_image(), jax_out[f"jnp_renderer/{illum}/n"])
    assert (image.max(-1) > 0).mean() > 0.3


def test_render_stats_snapshot_and_provisional(jax_out):
    model = sphere(jax_out)
    stats = {}
    for backend in ("ratio", "torch"):
        filler = pt.AdvancedPixelBufferFiller(SIZE, SIZE, fov=FOV,
                                              backend=backend, device="cpu")
        filler.render_arrays(*arrays(model), post="lambert_u8", light=light())
        assert filler.frame_provisional is False
        assert filler.validate_capacity() is True
        color, z, normal, img = filler.snapshot_buffers(strict=True)
        assert img.dtype == torch.uint8 and z.shape == (SIZE, SIZE, 1)
        assert torch.equal(img, filler.get_post_image())
        assert torch.equal(z, filler.get_z_buffer())
        stats[backend] = filler.get_render_stats()
    assert tuple(stats["ratio"]) == STATS_KEYS == tuple(
        str(k) for k in jax_out["stats/keys"])
    assert stats["ratio"] == dict.fromkeys(STATS_KEYS)     # JAX's jnp path
    assert all(stats["ratio"][k] is None for k in STATS_KEYS)
    kernel = stats["torch"]
    assert isinstance(kernel["pairs"], int) and kernel["pairs"] > 0
    assert isinstance(kernel["active_tiles"], int)
    assert 0 < kernel["active_tiles"] <= 3 * 6     # 96²: 3 x 6 tiles
    assert kernel["pair_capacity"] is None is kernel["live_group_capacity"]
    # the _rasterize compat wrapper returns the frame's G-buffers
    filler = pt.AdvancedPixelBufferFiller(SIZE, SIZE, fov=FOV, backend="ratio",
                                          device="cpu")
    got = filler._rasterize(*arrays(model))
    same_bits(got[1], jax_out["jnp/none/z"])


@pytest.mark.parametrize("backend", ["ratio", "torch"])
def test_custom_drawer_renderer_frame(jax_out, backend):
    """JAX ``renderer.py:124-142``: a custom drawer's frame is
    ``cast_u8(drawer.apply(color, normals))`` of the filler's G-buffers;
    z / normal buffers are the G-buffers."""
    filler = pt.AdvancedPixelBufferFiller(CUSTOM_SIZE, CUSTOM_SIZE, fov=FOV,
                                          backend=backend, device="cpu")
    renderer = pt.Renderer(filler, make_custom(pt), pt.SimpleIterator,
                           CUSTOM_SIZE, CUSTOM_SIZE)
    image = renderer.render(sphere(jax_out)).get_image()
    np.testing.assert_array_equal(image, jax_out[f"custom/{backend}/image"])
    same_bits(renderer.z_buffer.get_image(), jax_out[f"custom/{backend}/z"])
    same_bits(renderer.n_buffer.get_image(), jax_out[f"custom/{backend}/n"])
    color, _z, normals, _img = filler.snapshot_buffers()
    from cython3dmodelrenderer_tpu_torch.ops.illumination import cast_u8

    assert torch.equal(renderer.color_buffer.array,
                       cast_u8(make_custom(pt).apply(color, normals)))
    assert image.max() > 0


def test_draw_illumination_both_forms(jax_out):
    color_u8, normals = (jax_out["illum/color_u8"], jax_out["illum/normals"])
    color_buf = pt.Buffer(8, 8, dim=3, dtype="uint8", device="cpu")
    color_buf.array = torch.from_numpy(color_u8)
    n_buf = pt.Buffer(8, 8, dim=3, dtype="float32", device="cpu")
    n_buf.array = torch.from_numpy(normals)
    shader = pt.GuroIllumination([0.3, -0.2, 1.0])
    assert shader.draw_illumination(color_buf, n_buf) is None
    assert color_buf.array.dtype == torch.uint8
    np.testing.assert_array_equal(color_buf.get_image(), jax_out["illum/buffer"])
    raw = shader.draw_illumination(color_u8.astype(np.float32), normals)
    same_bits(raw, jax_out["illum/raw"])
    same_bits(pt.NoIllumination().draw_illumination(
        color_u8.astype(np.float32), normals), color_u8.astype(np.float32))


def compat_loop(tris, colors, normals, size, device="cpu"):
    filler = pt.AdvancedPixelBufferFiller(size, size, fov=FOV, device=device)
    bufs = (pt.Buffer(size, size, dim=3, dtype="float32", device=device),
            pt.Buffer(size, size, dim=1, dtype="float32", init_val=1e6,
                      device=device),
            pt.Buffer(size, size, dim=3, dtype="float32", device=device))
    for i in range(len(tris)):
        filler.compute_triangle_statistics(tris[i], colors[i], normals[i],
                                           *bufs)
    return [b.get_image() for b in bufs]


@pytest.mark.parametrize("scene", ["cube", "sphere250"])
def test_per_triangle_compat_path(jax_out, scene):
    """The compat loop equals JAX's bit for bit, and the batched ratio
    frame within JAX's own bounds (``test_renderer.py:224-227``)."""
    size = 64 if scene == "cube" else COMPAT_SIZE
    tris, colors, normals = (jax_out[f"compat/{scene}/{k}"]
                             for k in ("tris", "colors", "normals"))
    color, z, normal = compat_loop(tris, colors, normals, size)
    same_bits(color, jax_out[f"compat/{scene}/color"])
    same_bits(z, jax_out[f"compat/{scene}/z"])
    same_bits(normal, jax_out[f"compat/{scene}/normal"])
    batched = pt.AdvancedPixelBufferFiller(size, size, fov=FOV, backend="ratio",
                                           device="cpu")
    batched.render_arrays(*(torch.from_numpy(a) for a in (tris, normals, colors)))
    np.testing.assert_allclose(batched.get_color_buffer().numpy(), color,
                               atol=0.05, rtol=1e-4)
    np.testing.assert_allclose(batched.get_z_buffer().numpy(), z, atol=1e-5)
    assert (z < 1.0).sum() > 50


def test_compat_path_checks_buffers():
    filler = pt.AdvancedPixelBufferFiller(16, 16, device="cpu")
    small = pt.Buffer(8, 8, device="cpu")
    tri = np.zeros((3, 3), np.float32)
    with pytest.raises(AssertionError, match="spatial dimensions"):
        filler.compute_triangle_statistics(tri, tri, tri, small, small, small)


def test_per_triangle_renderer_with_depth_iterator(jax_out):
    """A filler outside the batched hierarchy takes the Renderer's
    per-triangle loop in ``DepthIterator`` order, then Guro's
    ``draw_illumination`` over the uint8 colour buffer."""
    inner = pt.AdvancedPixelBufferFiller(LOOP_SIZE, LOOP_SIZE, fov=FOV,
                                         device="cpu")
    renderer = pt.Renderer(make_per_triangle(pt, inner),
                           pt.GuroIllumination([0, 0, 1]), pt.DepthIterator,
                           LOOP_SIZE, LOOP_SIZE, device="cpu")
    image = renderer.render(sphere(jax_out)).get_image()
    np.testing.assert_array_equal(image, jax_out["loop/image"])
    same_bits(renderer.z_buffer.get_image(), jax_out["loop/z"])
    same_bits(renderer.n_buffer.get_image(), jax_out["loop/n"])
    assert image.max() > 0


def test_fragment_budget_refusal():
    """The ratio backend refuses a frame past its fragment budget on a
    CUDA device, as JAX refuses its jnp frames on the accelerator; the
    guard reads only the device object, so no card is needed."""
    with pytest.raises(ValueError, match="fragment budget.*backend='cuda'"):
        fillers.check_fragment_budget(384, torch.device("cuda"))
    fillers.check_fragment_budget(384, torch.device("cpu"))
    fillers.check_fragment_budget(352, torch.device("cuda"))   # 8·352² < 2^20
    assert 8 * 362 * 362 <= fillers.FRAGMENT_BUDGET < 8 * 363 * 363


def test_ratio_backend_is_chosen_only_by_name():
    from cython3dmodelrenderer_tpu_torch.config import BACKENDS, RenderConfig
    from cython3dmodelrenderer_tpu_torch.device import resolve_backend

    assert "ratio" in BACKENDS and RenderConfig(backend="ratio")
    assert resolve_backend("ratio", torch.device("cpu")) == "ratio"
    assert resolve_backend("ratio", torch.device("cuda")) == "ratio"
    assert resolve_backend("auto", torch.device("cpu")) == "torch"
    assert resolve_backend("auto", torch.device("cuda")) == "cuda"


# ---------------------------------------------------------------------------
# JAX reference (run as a script by ``jax_out``)
# ---------------------------------------------------------------------------

def _jax_main(job_path, out_path):
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    import cython3dmodelrenderer_tpu as jx

    del job_path
    out = {}
    model = jx.Model.read_model(os.path.join(REPO, "assets", "igor_sphere.obj"))
    model.rotate([-90, 180, 0])
    model.rotate([10, -80, 0])
    jx.fit_model(model)
    model.shift([0.0, 0.0, 1.0])
    colors = np.random.RandomState(0).uniform(
        0, 255, (model.n_vertices(), 3)).astype(np.float32)
    model._colors = jnp.asarray(colors)            # per-vertex colours,
    model._faces_vt = model._faces_v               # indexed like vertices
    for k, v in (("vertices", model._vertices), ("faces_v", model._faces_v),
                 ("normals", model._normals), ("faces_n", model._faces_n),
                 ("colors", colors), ("faces_vt", model._faces_v)):
        out[f"sphere/{k}"] = v
    tv, tn, tc = (model.vertices_by_triangles, model.normals_by_triangles,
                  model.colors_by_triangles)
    light = jx.GuroIllumination([0, 0, 1]).light_direction
    for post in ("none", "u8", "lambert_u8"):
        filler = jx.AdvancedPixelBufferFiller(SIZE, SIZE, fov=FOV, backend="jnp",
                                              fast_shade=True)
        filler.render_arrays(tv, tn, tc, post=post, light=light)
        color, z, normal, img = filler.snapshot_buffers()
        out.update({f"jnp/{post}/color": color, f"jnp/{post}/z": z,
                    f"jnp/{post}/normal": normal})
        if img is not None:
            out[f"jnp/{post}/image"] = img
        if post == "none":
            out["stats/keys"] = np.array(list(filler.get_render_stats()))
    for name, illum in (("guro", jx.GuroIllumination([0, 0, 1])),
                        ("none", jx.NoIllumination())):
        renderer = jx.Renderer(jx.AdvancedPixelBufferFiller(
            SIZE, SIZE, fov=FOV, backend="jnp"), illum, jx.SimpleIterator,
            SIZE, SIZE, use_tqdm=False)
        out[f"jnp_renderer/{name}/image"] = renderer.render(model).get_image()
        out[f"jnp_renderer/{name}/z"] = renderer.z_buffer.get_image()
        out[f"jnp_renderer/{name}/n"] = renderer.n_buffer.get_image()
    for backend, jbackend in (("ratio", "jnp"), ("torch", "pallas")):
        renderer = jx.Renderer(jx.AdvancedPixelBufferFiller(
            CUSTOM_SIZE, CUSTOM_SIZE, fov=FOV, backend=jbackend,
            interpret=True), make_custom(jx), jx.SimpleIterator, CUSTOM_SIZE,
            CUSTOM_SIZE, use_tqdm=False)
        out[f"custom/{backend}/image"] = renderer.render(model).get_image()
        out[f"custom/{backend}/z"] = renderer.z_buffer.get_image()
        out[f"custom/{backend}/n"] = renderer.n_buffer.get_image()

    rng = np.random.RandomState(3)
    color_u8 = rng.randint(0, 256, (8, 8, 3)).astype(np.uint8)
    normals = rng.randn(8, 8, 3).astype(np.float32)
    normals[0, 0] = 0.0                               # a zero normal
    out["illum/color_u8"], out["illum/normals"] = color_u8, normals
    shader = jx.GuroIllumination([0.3, -0.2, 1.0])
    cbuf = jx.Buffer(8, 8, dim=3, dtype="uint8")
    cbuf.array = jnp.asarray(color_u8)
    nbuf = jx.Buffer(8, 8, dim=3, dtype="float32")
    nbuf.array = jnp.asarray(normals)
    shader.draw_illumination(cbuf, nbuf)
    out["illum/buffer"] = cbuf.get_image()
    out["illum/raw"] = shader.draw_illumination(color_u8.astype(np.float32),
                                                normals)

    cube = jx.Model.read_model(os.path.join(REPO, "assets", "cube.obj"))
    cube.rotate([30, 40, 0])
    jx.fit_model(cube)
    cube_colors = np.repeat(np.random.RandomState(7).uniform(0, 255, (12, 1, 3)),
                            3, axis=1).astype(np.float32)
    spread = np.arange(COMPAT_N) * 24       # 250 triangles over the sphere
    scenes = {"cube": (64, np.asarray(cube.vertices_by_triangles), cube_colors,
                       np.asarray(cube.normals_by_triangles)),
              "sphere250": (COMPAT_SIZE, np.asarray(tv)[spread],
                            np.asarray(tc)[spread], np.asarray(tn)[spread])}
    for name, (size, tris, cols, norms) in scenes.items():
        filler = jx.AdvancedPixelBufferFiller(size, size, fov=FOV, backend="jnp")
        bufs = (jx.Buffer(size, size, dim=3, dtype="float32"),
                jx.Buffer(size, size, dim=1, dtype="float32", init_val=1e6),
                jx.Buffer(size, size, dim=3, dtype="float32"))
        for i in range(len(tris)):
            filler.compute_triangle_statistics(tris[i], cols[i], norms[i], *bufs)
        out.update({f"compat/{name}/tris": tris, f"compat/{name}/colors": cols,
                    f"compat/{name}/normals": norms})
        for part, buf in zip(("color", "z", "normal"), bufs):
            out[f"compat/{name}/{part}"] = buf.get_image()

    inner = jx.AdvancedPixelBufferFiller(LOOP_SIZE, LOOP_SIZE, fov=FOV,
                                         backend="jnp")
    renderer = jx.Renderer(make_per_triangle(jx, inner),
                           jx.GuroIllumination([0, 0, 1]), jx.DepthIterator,
                           LOOP_SIZE, LOOP_SIZE, use_tqdm=False)
    out["loop/image"] = renderer.render(model).get_image()
    out["loop/z"] = renderer.z_buffer.get_image()
    out["loop/n"] = renderer.n_buffer.get_image()
    np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})


if __name__ == "__main__":
    _jax_main(sys.argv[1], sys.argv[2])
