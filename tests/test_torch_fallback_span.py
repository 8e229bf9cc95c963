"""The fallback colours of untextured models (``Renderer._fallback_colors``)
and their span ``fallback_colors`` on the CPU: one span inside each
untextured frame's ``render`` and none in a textured frame, the shared
no-op while no profiler runs, and colours that keep the generator rule
bit for bit."""
import contextlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import cython3dmodelrenderer_tpu_torch as pt
from cython3dmodelrenderer_tpu_torch.utils import timing

SIZE = 48
SEED = 11


@pytest.fixture
def cube(cube_path):
    model = pt.Model.read_model(cube_path, device="cpu")
    model.rotate([30, 40, 0])
    pt.fit_model(model)
    return model


@pytest.fixture
def textured(cube):
    """The cube with one colour a vertex."""
    faces = cube._faces_v.numpy()
    state = {"vertices": cube.vertices.numpy(), "faces_v": faces,
             "normals": cube.normals.numpy(), "faces_n": cube._faces_n.numpy(),
             "colors": torch.arange(3 * len(cube.vertices)).reshape(-1, 3)
             .float().numpy(), "faces_vt": faces}
    return pt.Model.from_state(state, device="cpu")


def renderer():
    filler = pt.AdvancedPixelBufferFiller(SIZE, SIZE, fov=60, backend="torch",
                                          device="cpu")
    return pt.Renderer(filler, pt.GuroIllumination([0, 0, 1]),
                       pt.SimpleIterator, SIZE, SIZE,
                       generator=torch.Generator().manual_seed(SEED))


def spans(prof, name):
    return sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                  if e.name == timing.SPAN_PREFIX + name)


def test_one_span_an_untextured_frame_and_none_a_textured_one(cube, textured):
    r = renderer()
    r.render(cube)                                      # warm
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for model in (cube, textured, cube, textured, textured):
            r.render(model)
    renders, fallback = spans(prof, "render"), spans(prof, "fallback_colors")
    assert len(renders) == 5 and len(fallback) == 2
    for (a, b), (lo, hi) in zip(fallback, [renders[0], renders[2]]):
        assert lo <= a <= b <= hi                       # a child of render


def test_no_span_entered_without_a_profiler(monkeypatch, cube, textured):
    def refuse(*_args, **_kwargs):
        raise AssertionError("record_function entered with no profiler")

    span, given = timing.span, []

    def recorded(name):
        given.append((name, span(name)))
        return given[-1][1]
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(timing, "span", recorded)
    r = renderer()
    r.render(textured)
    assert "fallback_colors" not in [n for n, _s in given]
    r.render(cube)
    fallback = [s for n, s in given if n == "fallback_colors"]
    assert fallback == [timing._NO_SPAN]


@pytest.mark.parametrize("random_colors", [True, False])
@pytest.mark.parametrize("traced", [False, True])
def test_fallback_colours_keep_the_generator_rule(cube, textured,
                                                  random_colors, traced):
    """The colours are those of ``torch.randint(256, (T, 3))`` from the
    renderer's generator (else white), float32, one for the three
    vertices of each triangle, with or without a profiler."""
    r = renderer()
    t = cube.n_triangles()
    with (profile(activities=[ProfilerActivity.CPU]) if traced
          else contextlib.nullcontext()):
        got = [r._fallback_colors(cube, random_colors) for _ in range(2)]
        assert r._fallback_colors(textured, random_colors) is None
    generator = torch.Generator().manual_seed(SEED)
    for colors in got:
        per_tri = (torch.randint(256, (t, 3), generator=generator)
                   if random_colors else torch.full((t, 3), 255))
        want = per_tri.to(torch.float32)[:, None, :].expand(t, 3, 3)
        assert colors.dtype == torch.float32 and colors.is_contiguous()
        assert torch.equal(colors, want)
