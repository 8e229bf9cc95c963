"""A textured model's triangle colours (``Model.colors_by_triangles``) on
the CPU: gathered once a model and kept across frames and vertex
transforms, counted in ``timing.counters["colors_gathered"]``, and giving
the images of a gather on every access (the reference, patched in by
``uncached``)."""
import numpy as np
import pytest
import torch

import cython3dmodelrenderer_tpu_torch as pt
from conftest import _asset
from cython3dmodelrenderer_tpu_torch.models import obj_io
from cython3dmodelrenderer_tpu_torch.parallel import multiview
from cython3dmodelrenderer_tpu_torch.utils import timing

SIZE = 64


def gathered():
    return timing.counters["colors_gathered"]


def fresh_gather(model):
    return model._colors[model._faces_vt.long()]


@pytest.fixture(scope="module")
def igor_obj():
    return obj_io.load_obj(_asset("igor_sphere.obj"))


def igor_init(data):
    """igor through ``Model.__init__`` with a seeded texture (the OBJ's
    own texture file is not in the repository), posed as the tests pose it."""
    texture = np.random.RandomState(5).randint(0, 256, (64, 32, 3),
                                               dtype=np.uint8)
    model = pt.Model(data.vertices, data.faces_v,
                     texture_coords=data.texture_coords,
                     triangles_texture_coords=data.faces_vt, texture=texture,
                     normals=data.normals, triangles_normals=data.faces_vn,
                     device="cpu")
    model.rotate([-90, 180, 0])
    pt.fit_model(model)
    return model


def state_of(model, colors=None):
    faces = model._faces_v.numpy()
    state = {"vertices": model.vertices.numpy(), "faces_v": faces,
             "normals": model.normals.numpy(),
             "faces_n": model._faces_n.numpy()}
    if colors is not None:
        state.update(colors=colors, faces_vt=faces)
    return state


def seeded_colors(model, seed):
    return np.random.RandomState(seed).uniform(
        0, 255, (model.n_vertices(), 3)).astype(np.float32)


def build(data, source):
    """A textured model: ``init`` (texture sampled at load) or ``state``
    (``Model.from_state`` with a colour a vertex)."""
    model = igor_init(data)
    if source == "state":
        model = pt.Model.from_state(state_of(model, seeded_colors(model, 1)),
                                    device="cpu")
    return model


@pytest.fixture
def uncached(monkeypatch):
    """Patch in the reference property: a gather on every access."""
    def patch():
        monkeypatch.setattr(pt.Model, "colors_by_triangles", property(
            lambda m: None if m._colors is None else fresh_gather(m)))
    return patch


def renderer(post):
    filler = pt.AdvancedPixelBufferFiller(SIZE, SIZE, fov=60, backend="torch",
                                          device="cpu")
    light = (pt.GuroIllumination([0, 0, 1]) if post == "lambert_u8"
             else pt.NoIllumination())
    return pt.Renderer(filler, light, pt.SimpleIterator, SIZE, SIZE,
                       generator=torch.Generator().manual_seed(3))


def wireframe_renderer():
    filler = pt.EdgeOnlyPixelBufferFiller(pt.LineBresenham(), [255] * 3,
                                          force_triangle_colors=True)
    return pt.Renderer(filler, pt.NoIllumination(), pt.SimpleIterator, SIZE,
                       SIZE, device="cpu")


def frames(model, path, n=3):
    """``n`` images of ``model`` through the Renderer's ``path``."""
    if path == "sequence":
        r = renderer("lambert_u8")
        angles = multiview.turntable_angles(2)
        return [r.render_sequence(model, angles).numpy() for _ in range(n)]
    if path == "wireframe":
        r = wireframe_renderer()
        return [r.render(model, normalize_model=not k).get_image()
                for k in range(n)]
    r = renderer(path)
    return [r.render(model).get_image() for _ in range(n)]


@pytest.mark.parametrize("source", ["init", "state"])
def test_one_gather_a_model_bit_equal_to_a_fresh_one(igor_obj, source):
    """Repeated access returns the same tensor, which holds the bits of a
    fresh gather in float32 on the model's device."""
    model = build(igor_obj, source)
    before = gathered()
    first = model.colors_by_triangles
    assert model.colors_by_triangles is first
    assert model.colors_by_triangles is first
    assert gathered() == before + 1
    want = fresh_gather(model)
    assert first.dtype == torch.float32 and first.device == model.device
    assert first.shape == (model.n_triangles(), 3, 3)
    assert torch.equal(first.view(torch.int32), want.view(torch.int32))
    assert model.has_colors


@pytest.mark.parametrize("path", ["u8", "lambert_u8", "sequence",
                                  "wireframe"])
def test_frames_gather_once_and_match_a_gather_a_frame(igor_obj, uncached,
                                                       path):
    """Three frames (or sweeps) of one textured model gather once, and
    give the images of the uncached property on an equal model."""
    model = build(igor_obj, "state")
    before = gathered()
    got = frames(model, path)
    assert gathered() == before + 1
    uncached()
    want = frames(build(igor_obj, "state"), path)
    assert gathered() == before + 1
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[0].any()


@pytest.mark.parametrize("transform", [("rotate", [10, -30, 5]),
                                       ("shift", [0.05, -0.02, 0.1]),
                                       ("scale", 0.8)],
                         ids=lambda t: t[0])
def test_the_colours_survive_vertex_transforms(igor_obj, uncached, transform):
    """``rotate``, ``shift`` and ``scale`` drop the vertex and normal
    arrays but keep the colours' gather; the next frame is that of the
    uncached property."""
    name, arg = transform

    def scenario(model):
        r = renderer("lambert_u8")
        out = [r.render(model).get_image()]
        colors = model.colors_by_triangles
        getattr(model, name)(arg)
        assert model._vbt_cache is None and model._nbt_cache is None
        kept = model.colors_by_triangles is colors
        out.append(r.render(model).get_image())
        return out, kept

    before = gathered()
    got, kept = scenario(build(igor_obj, "init"))
    assert kept and gathered() == before + 1
    uncached()
    want, _ = scenario(build(igor_obj, "init"))
    np.testing.assert_array_equal(got[1], want[1])
    assert not np.array_equal(got[0], got[1])


@pytest.mark.parametrize("source", ["read_model", "state"])
def test_an_untextured_model_gathers_nothing(cube_path, source):
    model = pt.Model.read_model(cube_path, device="cpu")
    model.rotate([30, 40, 0])
    pt.fit_model(model)
    if source == "state":
        model = pt.Model.from_state(state_of(model), device="cpu")
    before = gathered()
    assert not model.has_colors and model.colors_by_triangles is None
    images = frames(model, "lambert_u8", n=2)
    assert gathered() == before
    assert model._cbt_cache is None and images[0].any()


def test_two_models_keep_separate_caches(igor_obj):
    """Two ``from_state`` models of one mesh with other colours: each
    keeps its own gather, and their frames differ."""
    base = igor_init(igor_obj)
    a, b = (pt.Model.from_state(state_of(base, seeded_colors(base, seed)),
                                device="cpu") for seed in (1, 2))
    before = gathered()
    ca, cb = a.colors_by_triangles, b.colors_by_triangles
    assert gathered() == before + 2
    assert ca.data_ptr() != cb.data_ptr() and not torch.equal(ca, cb)
    assert torch.equal(ca, fresh_gather(a)) and torch.equal(cb, fresh_gather(b))
    assert a.colors_by_triangles is ca and b.colors_by_triangles is cb
    r = renderer("u8")
    ia, ib = (r.render(m).get_image() for m in (a, b))
    assert not np.array_equal(ia, ib)
    assert gathered() == before + 2
