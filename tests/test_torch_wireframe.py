"""Port wireframe (``ops/wireframe.py``, ``EdgeOnlyPixelBufferFiller``)
against the JAX package.

The JAX side (this file as a script, in a subprocess with
``--xla_cpu_max_isa=AVX`` as ``test_torch_raster.py`` runs it) draws the
20 random lines and the 7 far-off-screen lines of
``tests/test_renderer.py:133-186`` with ``wireframe.rasterize_lines`` and
renders the wireframe Renderer frames (cube at 64², igor_sphere at 128²,
``normalize_model=True``, edges and vertices only) from the posed arrays it
hands over. The port must match BIT FOR BIT; its scalar ``LineBresenham``
must equal its closed form, and a custom ``LineDrawer`` must see every
edge.
"""
import os
import sys

import numpy as np
import pytest
import torch

from test_torch_raster import REPO, run_jax_reference

import cython3dmodelrenderer_tpu_torch as pt
from cython3dmodelrenderer_tpu_torch.ops import wireframe

H = W = 48
RED = [255.0, 0.0, 0.0]
FAR_CASES = [
    ((-10000, 20), (10000, 30)),     # near-horizontal, both far out
    ((25, -9000), (20, 9000)),       # near-vertical
    ((-8000, -7990), (8000, 8010)),  # diagonal
    ((-12000, -300), (12000, 400)),  # shallow slope crossing
    ((5, 5), (20000, 5011)),         # one endpoint far out
    ((-5000, 100), (-4000, 90)),     # fully off-screen → empty
    ((2, 3), (2, 3)),                # degenerate point, on-screen
]
MODELS = {"cube": 64, "sphere": 128}
STATE_KEYS = ("vertices", "faces_v", "normals", "faces_n")


def line_cases():
    """(name, p1, p2, max_steps): ``test_wireframe_matches_scalar_bresenham``
    and ``test_wireframe_far_offscreen_endpoints``."""
    rng = np.random.RandomState(5)
    cases = [(f"random{i}", tuple(rng.randint(-5, 53, size=2)),
              tuple(rng.randint(-5, 53, size=2)), 128) for i in range(20)]
    return cases + [(f"far{i}", p1, p2, 2 * max(H, W))
                    for i, (p1, p2) in enumerate(FAR_CASES)]


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    return run_jax_reference(os.path.abspath(__file__), {"run": np.array(1)},
                             tmp_path_factory.mktemp("jax_wireframe"))


def port_line(p1, p2, max_steps):
    return wireframe.rasterize_lines(
        torch.zeros((H, W, 3)), torch.tensor([p1], dtype=torch.int32),
        torch.tensor([p2], dtype=torch.int32), torch.tensor([RED]),
        torch.ones(1, dtype=torch.bool), H, W, max_steps)


@pytest.mark.parametrize("case", line_cases(), ids=lambda c: c[0])
def test_rasterize_lines_bit_equal(jax_out, case):
    name, p1, p2, max_steps = case
    got = port_line(p1, p2, max_steps)
    np.testing.assert_array_equal(got.numpy(), jax_out[f"line/{name}"])
    # the scalar walk over a Buffer draws the same pixels
    buf = pt.Buffer(H, W, dim=3, dtype="float32", device="cpu")
    pt.LineBresenham().draw_line(list(p1), list(p2), buf, RED)
    np.testing.assert_array_equal(got.numpy(), buf.get_image())


def test_line_chunks_and_priority(monkeypatch):
    """Passes of a few lines each give the image of one pass: the last
    line wins a crossing, inactive lines draw nothing."""
    rng = np.random.RandomState(8)
    n = 40
    p1 = torch.from_numpy(rng.randint(-10, 60, (n, 2)).astype(np.int32))
    p2 = torch.from_numpy(rng.randint(-10, 60, (n, 2)).astype(np.int32))
    colors = torch.arange(1, n + 1, dtype=torch.float32)[:, None].expand(n, 3)
    active = torch.from_numpy(rng.rand(n) > 0.2)
    base = torch.full((H, W, 3), -1.0)
    whole = wireframe.rasterize_lines(base, p1, p2, colors, active, H, W, 96)
    monkeypatch.setattr(wireframe, "LINE_ELEMS", 3 * 96)
    assert torch.equal(wireframe.rasterize_lines(base, p1, p2, colors, active,
                                                 H, W, 96), whole)
    buf = pt.Buffer(H, W, dim=3, dtype="float32", init_val=-1.0, device="cpu")
    for i in range(n):                     # the reference's sequential order
        if active[i]:
            pt.LineBresenham().draw_line(p1[i].tolist(), p2[i].tolist(), buf,
                                         [float(i + 1)] * 3)
    np.testing.assert_array_equal(whole.numpy(), buf.get_image())
    empty = wireframe.rasterize_lines(base, p1[:0], p2[:0], colors[:0],
                                      active[:0], H, W, 96)
    assert torch.equal(empty, base)


def test_float_to_int_truncation():
    x = torch.tensor([1.9, -1.9, float("nan"), 3e9, -3e9, float("inf"), 0.0])
    assert wireframe.to_i32(x).tolist() == [1, -1, 0, 2 ** 31 - 1, -2 ** 31,
                                            2 ** 31 - 1, 0]


def wire_model(jax_out, name):
    return pt.Model.from_state({k: jax_out[f"{name}/{k}"] for k in STATE_KEYS},
                               device="cpu")


@pytest.mark.parametrize("draw_edges", [True, False], ids=["edges", "vertices"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_edge_only_renderer_matches_jax(jax_out, name, draw_edges):
    size = MODELS[name]
    filler = pt.EdgeOnlyPixelBufferFiller(pt.LineBresenham(),
                                          np.array([255, 255, 255]),
                                          draw_edges=draw_edges)
    renderer = pt.Renderer(filler, pt.NoIllumination(), pt.SimpleIterator,
                           size, size, device="cpu")
    model = wire_model(jax_out, name)
    image = renderer.render(model, normalize_model=True).get_image()
    # the fit runs on each side (within transforms' 1e-6 scale); the
    # truncated endpoints, and so the pixels, agree
    np.testing.assert_allclose(model.vertices_by_triangles.numpy(),
                               jax_out[f"{name}/fitted"], rtol=1e-6, atol=1e-4)
    kind = "edges" if draw_edges else "vertices"
    np.testing.assert_array_equal(image, jax_out[f"{name}/image/{kind}"])
    lit = (image.sum(-1) > 0).sum()
    assert image.max() == 255 and 0 < lit < 0.7 * size * size
    if not draw_edges:
        assert lit <= 3 * model.n_triangles()
    # fill_all on JAX's own fitted arrays: the same image
    tv = torch.from_numpy(jax_out[f"{name}/fitted"])
    got = filler.fill_all(tv, torch.zeros_like(tv), torch.zeros((size, size, 3)))
    np.testing.assert_array_equal(got.to(torch.uint8).numpy(), image)


def test_triangle_colours_and_edges():
    """``force_triangle_colors`` takes each vertex's colour for the edge
    that starts there, and the edge order is p0→p1, p1→p2, p2→p0."""
    tris = torch.tensor([[[2.0, 2.0, 0.0], [20.0, 2.0, 0.0], [2.0, 20.0, 0.0]]])
    colors = torch.tensor([[[10.0] * 3, [20.0] * 3, [30.0] * 3]])
    filler = pt.EdgeOnlyPixelBufferFiller(pt.LineBresenham(), [255, 255, 255],
                                          force_triangle_colors=True)
    img = filler.fill_all(tris, colors, torch.zeros((24, 24, 3)))
    assert float(img[2, 10, 0]) == 10.0           # p0 → p1
    assert float(img[10, 12, 0]) == 20.0          # p1 → p2 (the diagonal)
    assert float(img[10, 2, 0]) == 30.0           # p2 → p0
    assert float(img[2, 2, 0]) == 30.0            # the last edge wins p0
    starts, ends = wireframe.triangle_edges(torch.tensor([[[0, 1], [2, 3], [4, 5]]]))
    assert starts.tolist() == [[0, 1], [2, 3], [4, 5]]
    assert ends.tolist() == [[2, 3], [4, 5], [0, 1]]


def test_custom_line_drawer_sees_every_edge(cube_path):
    """``test_renderer.py:396``: a drawer that is not exactly
    ``LineBresenham`` takes the per-triangle loop and receives 3·T edges."""
    class RecordingDrawer(pt.LineDrawer):
        def __init__(self):
            self.calls = []

        def draw_line(self, p1, p2, buffer, color):
            self.calls.append((tuple(p1), tuple(p2)))

    model = pt.Model.read_model(cube_path, device="cpu")
    drawer = RecordingDrawer()
    filler = pt.EdgeOnlyPixelBufferFiller(drawer, np.array([255, 255, 255]))
    renderer = pt.Renderer(filler, pt.NoIllumination(), pt.SimpleIterator,
                           64, 64, device="cpu")
    renderer.render(model, normalize_model=True)
    assert len(drawer.calls) == model.n_triangles() * 3
    assert renderer.color_buffer.get_image().max() == 0

    class Subclassed(pt.LineBresenham):
        pass

    image = pt.Renderer(pt.EdgeOnlyPixelBufferFiller(Subclassed(), [255] * 3),
                        pt.NoIllumination(), pt.SimpleIterator, 64, 64,
                        device="cpu").render(model).get_image()
    batched = pt.Renderer(pt.EdgeOnlyPixelBufferFiller(pt.LineBresenham(),
                                                       [255] * 3),
                          pt.NoIllumination(), pt.SimpleIterator, 64, 64,
                          device="cpu").render(model).get_image()
    np.testing.assert_array_equal(image, batched)      # loop == closed form
    assert image.max() == 255


# ---------------------------------------------------------------------------
# JAX reference (run as a script by ``jax_out``)
# ---------------------------------------------------------------------------

def _jax_main(job_path, out_path):
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    import cython3dmodelrenderer_tpu as jx
    from cython3dmodelrenderer_tpu.ops import wireframe as jw

    del job_path
    out = {}
    for name, p1, p2, max_steps in line_cases():
        out[f"line/{name}"] = jw.rasterize_lines(
            jnp.zeros((H, W, 3), jnp.float32), jnp.asarray([p1], jnp.int32),
            jnp.asarray([p2], jnp.int32), jnp.asarray([RED]),
            jnp.ones((1,), bool), H, W, max_steps=max_steps)
    assets = {"cube": "cube.obj", "sphere": "igor_sphere.obj"}
    for name, size in MODELS.items():
        model = jx.Model.read_model(os.path.join(REPO, "assets", assets[name]))
        if name == "sphere":
            model.rotate([-90, 180, 0])
        for k, v in (("vertices", model._vertices), ("faces_v", model._faces_v),
                     ("normals", model._normals), ("faces_n", model._faces_n)):
            out[f"{name}/{k}"] = v
        for kind, draw_edges in (("edges", True), ("vertices", False)):
            fitted = jx.Model.read_model(os.path.join(REPO, "assets",
                                                      assets[name]))
            if name == "sphere":
                fitted.rotate([-90, 180, 0])
            filler = jx.EdgeOnlyPixelBufferFiller(
                jx.LineBresenham(), np.array([255, 255, 255]),
                draw_edges=draw_edges)
            renderer = jx.Renderer(filler, jx.NoIllumination(),
                                   jx.SimpleIterator, size, size,
                                   use_tqdm=False)
            out[f"{name}/image/{kind}"] = renderer.render(
                fitted, normalize_model=True).get_image()
            out[f"{name}/fitted"] = fitted.vertices_by_triangles
    np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})


if __name__ == "__main__":
    _jax_main(sys.argv[1], sys.argv[2])
