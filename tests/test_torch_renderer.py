"""Port ``Renderer.render`` against the JAX ``Renderer`` on igor_sphere.

Both sides get one numpy model state (the JAX model's posed arrays, handed
to the port through ``Model.from_state``) and one per-vertex colour array.
The JAX side is the JAX package's own ``Renderer`` with
``AdvancedPixelBufferFiller(backend="pallas", interpret=True)``, run in a
subprocess (this file as a script) with FMA contraction off
(``--xla_cpu_max_isa=AVX``; see ``test_torch_raster.py`` for why), so the
port must match it bit for bit: the Guro and NoIllumination images and the
lazy z / normal buffers.
"""
import os
import sys

import numpy as np
import pytest
import torch

from test_torch_raster import REPO, run_jax_reference

import cython3dmodelrenderer_tpu_torch as pt

SIZE = 128
FOV = 45
C1_SIZE = 64            # the ROADMAP C1 scene: igor_sphere fitted, (0, 0, 1)


@pytest.fixture(scope="module")
def jax_render(tmp_path_factory):
    out = run_jax_reference(os.path.abspath(__file__),
                            {"size": np.array([SIZE, FOV])},
                            tmp_path_factory.mktemp("jax_renderer"))
    assert out["normals"].shape == out["vertices"].shape
    return out


def port_model(ref):
    state = {k: ref[k] for k in ("vertices", "faces_v", "normals", "faces_n",
                                 "colors", "faces_vt")}
    return pt.Model.from_state(state, device="cpu")


def port_renderer(illum):
    filler = pt.AdvancedPixelBufferFiller(SIZE, SIZE, fov=FOV, device="cpu")
    return pt.Renderer(filler, illum, pt.SimpleIterator, SIZE, SIZE)


@pytest.mark.parametrize("illum", ["guro", "none"])
def test_render_matches_jax(jax_render, illum):
    shader = (pt.GuroIllumination([0, 0, 1]) if illum == "guro"
              else pt.NoIllumination())
    renderer = port_renderer(shader)
    image = renderer.render(port_model(jax_render)).get_image()
    np.testing.assert_array_equal(image, jax_render[f"{illum}/image"])
    assert (image.max(-1) > 0).mean() > 0.5
    # lazy G-buffer views: a re-render with G-buffer output, bit-identical
    z = renderer.z_buffer.get_image()
    n = renderer.n_buffer.get_image()
    np.testing.assert_array_equal(z.view(np.int32),
                                  jax_render[f"{illum}/z"].view(np.int32))
    np.testing.assert_array_equal(n.view(np.int32),
                                  jax_render[f"{illum}/n"].view(np.int32))
    assert z.max() == np.float32(1e6) and z.min() < 1.0


def c1_order_types(pkg):
    """``SimpleIterator`` and two iterator types with no order of their
    own: a ``TriangleIterator`` subclass (its ``order_indices`` raises
    ``NotImplementedError``) and ``object`` (no ``order_indices``)."""
    class NoOrder(pkg.TriangleIterator):
        pass

    return {"simple": pkg.SimpleIterator, "no_order": NoOrder,
            "object": object}


@pytest.mark.parametrize("order", ["no_order", "object"])
def test_iterator_without_order_renders_in_model_order(jax_render, order):
    """ROADMAP C1: an iterator type without ``order_indices`` renders in
    model order, byte-equal to JAX's frame and to ``SimpleIterator``'s."""
    state = {k: jax_render[f"c1/{k}"] for k in ("vertices", "faces_v",
                                                "normals", "faces_n",
                                                "colors", "faces_vt")}

    def render(iterator):
        filler = pt.AdvancedPixelBufferFiller(C1_SIZE, C1_SIZE, fov=FOV,
                                              device="cpu")
        renderer = pt.Renderer(filler, pt.GuroIllumination([0, 0, 1]),
                               iterator, C1_SIZE, C1_SIZE)
        return renderer.render(pt.Model.from_state(state,
                                                   device="cpu")).get_image()

    types = c1_order_types(pt)
    image = render(types[order])
    np.testing.assert_array_equal(image, jax_render[f"c1/{order}"])
    np.testing.assert_array_equal(image, jax_render["c1/simple"])
    np.testing.assert_array_equal(image, render(types["simple"]))
    assert (image.max(-1) > 0).mean() > 0.3


def test_from_state_round_trip(jax_render):
    model = port_model(jax_render)
    np.testing.assert_array_equal(model.vertices.numpy(), jax_render["vertices"])
    np.testing.assert_array_equal(model.normals.numpy(), jax_render["normals"])
    np.testing.assert_array_equal(
        model.colors_by_triangles.numpy(),
        jax_render["colors"][jax_render["faces_vt"]])
    assert model.n_triangles() == 6016


def test_untextured_colours_come_from_the_generator(igor_sphere_path):
    model = pt.Model.read_model(igor_sphere_path, device="cpu")
    model.rotate([-90, 180, 0])
    pt.fit_model(model)
    model.shift([0.0, 0.0, 1.0])

    def render(seed):
        filler = pt.AdvancedPixelBufferFiller(32, 32, fov=FOV, device="cpu")
        r = pt.Renderer(filler, pt.NoIllumination(), pt.SimpleIterator, 32, 32,
                        generator=torch.Generator().manual_seed(seed))
        return r.render(model).get_image()

    assert np.array_equal(render(5), render(5))
    assert not np.array_equal(render(5), render(6))
    white = pt.Renderer(pt.AdvancedPixelBufferFiller(32, 32, fov=FOV,
                                                      device="cpu"),
                        pt.NoIllumination(), pt.SimpleIterator, 32, 32)
    lit = white.render(model, random_colors=False).get_image()
    lit = lit[lit.max(-1) > 0]
    assert len(lit) and np.all(lit == lit[:, :1])          # grey levels


def test_depth_iterator_order_and_reset(cube_path):
    model = pt.Model.read_model(cube_path, device="cpu")
    model.rotate([30, 40, 0])
    pt.fit_model(model)
    renderer = pt.Renderer(pt.AdvancedPixelBufferFiller(48, 48, fov=60,
                                                        device="cpu"),
                           pt.GuroIllumination([0, 0, 1]), pt.DepthIterator,
                           48, 48)
    assert renderer.render(model).get_image().max() > 0
    order = pt.DepthIterator.order_indices(model).numpy()
    min_z = model.vertices_by_triangles[:, :, 2].min(dim=1).values.numpy()
    assert np.all(np.diff(min_z[order]) >= 0)
    assert len(list(pt.DepthIterator(model))) == model.n_triangles()
    renderer.reset_buffers()
    assert renderer.color_buffer.get_image().max() == 0
    assert renderer.z_buffer.get_image().min() == np.float32(1e6)


def test_unported_paths_raise():
    """No Renderer path raises any more; each does what JAX does. A custom
    drawer shades the frame's G-buffers; a plain ``PixelBufferFiller``,
    whose ``compute_triangle_statistics`` is an abstract method with a
    ``...`` body on a class that is not an ABC (JAX ``fillers.py:45-50``),
    takes the per-triangle loop, draws nothing and leaves the background."""
    import cython3dmodelrenderer_tpu as jx

    class Custom(pt.IlluminationDrawer):
        def apply(self, color, n_buffer):
            return color

    model = pt.Model(np.eye(3, dtype=np.float32), [[0, 1, 2]], device="cpu")
    image = port_renderer(Custom()).render(model, random_colors=False)
    assert image.get_image().shape == (SIZE, SIZE, 3)
    assert pt.PixelBufferFiller().compute_triangle_statistics(
        *([None] * 6)) is None
    plain = pt.Renderer(pt.PixelBufferFiller(), pt.GuroIllumination([0, 0, 1]),
                        pt.DepthIterator, 8, 8, device="cpu")
    assert plain.render(model).get_image().max() == 0
    assert plain.z_buffer.get_image().min() == np.float32(1e6)
    jax_plain = jx.Renderer(jx.PixelBufferFiller(),
                            jx.GuroIllumination([0, 0, 1]), jx.DepthIterator,
                            8, 8, use_tqdm=False)
    jax_image = jax_plain.render(jx.Model(np.eye(3, dtype=np.float32),
                                          [[0, 1, 2]])).get_image()
    np.testing.assert_array_equal(plain.color_buffer.get_image(), jax_image)


# ---------------------------------------------------------------------------
# JAX reference (run as a script by ``jax_render``)
# ---------------------------------------------------------------------------

def _jax_main(job_path, out_path):
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    import cython3dmodelrenderer_tpu as jx

    with np.load(job_path) as f:
        size, fov = (int(v) for v in f["size"])
    model = jx.Model.read_model(os.path.join(REPO, "assets", "igor_sphere.obj"))
    model.rotate([-90, 180, 0])
    model.rotate([10, -80, 0])
    jx.fit_model(model)
    model.shift([0.0, 0.0, 1.0])
    rng = np.random.RandomState(0)
    colors = rng.uniform(0, 255, (model.n_vertices(), 3)).astype(np.float32)
    model._colors = jnp.asarray(colors)            # per-vertex colours,
    model._faces_vt = model._faces_v               # indexed like vertices
    out = {"vertices": model._vertices, "faces_v": model._faces_v,
           "normals": model._normals, "faces_n": model._faces_n,
           "colors": colors, "faces_vt": model._faces_v}
    for name, illum in (("guro", jx.GuroIllumination([0, 0, 1])),
                        ("none", jx.NoIllumination())):
        filler = jx.AdvancedPixelBufferFiller(size, size, fov=fov,
                                              backend="pallas", interpret=True)
        renderer = jx.Renderer(filler, illum, jx.SimpleIterator, size, size,
                               use_tqdm=False)
        out[f"{name}/image"] = renderer.render(model).get_image()
        out[f"{name}/z"] = renderer.z_buffer.get_image()
        out[f"{name}/n"] = renderer.n_buffer.get_image()
    model = jx.Model.read_model(os.path.join(REPO, "assets", "igor_sphere.obj"))
    jx.fit_model(model)
    model.shift([0.0, 0.0, 1.0])
    colors = rng.uniform(0, 255, (model.n_vertices(), 3)).astype(np.float32)
    model._colors = jnp.asarray(colors)
    model._faces_vt = model._faces_v
    out.update({"c1/vertices": model._vertices, "c1/faces_v": model._faces_v,
                "c1/normals": model._normals, "c1/faces_n": model._faces_n,
                "c1/colors": colors, "c1/faces_vt": model._faces_v})
    for name, iterator in c1_order_types(jx).items():
        filler = jx.AdvancedPixelBufferFiller(C1_SIZE, C1_SIZE, fov=fov,
                                              backend="pallas", interpret=True)
        renderer = jx.Renderer(filler, jx.GuroIllumination([0, 0, 1]),
                               iterator, C1_SIZE, C1_SIZE, use_tqdm=False)
        out[f"c1/{name}"] = renderer.render(model).get_image()
    np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})


if __name__ == "__main__":
    _jax_main(sys.argv[1], sys.argv[2])
