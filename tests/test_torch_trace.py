"""The port's own spans and counters (``utils/timing.py``: ``span``,
``counters``) on the CPU: the gate that keeps a frame free of profiler
ranges while no profiler runs, the spans a frame and a sweep emit under
the profiler, which leave the output as it is, and the seconds counters
of model loads and kernel builds."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import cython3dmodelrenderer_tpu_torch as pt
from cython3dmodelrenderer_tpu_torch import cuda_build
from cython3dmodelrenderer_tpu_torch.utils import timing

SIZE = 64
FRAME_SPANS = ["front_end", "bins", "raster", "pair_total"]


@pytest.fixture
def cube(cube_path):
    model = pt.Model.read_model(cube_path, device="cpu")
    model.rotate([30, 40, 0])
    pt.fit_model(model)
    return model


def renderer(illumination=None):
    filler = pt.AdvancedPixelBufferFiller(SIZE, SIZE, fov=60, backend="torch",
                                          device="cpu")
    return pt.Renderer(filler, illumination or pt.GuroIllumination([0, 0, 1]),
                       pt.SimpleIterator, SIZE, SIZE,
                       generator=torch.Generator().manual_seed(3))


def program_spans(prof):
    """(stage, start, end) of the program's spans, in order of start."""
    out = [(e.name[len(timing.SPAN_PREFIX):], e.time_range.start,
            e.time_range.end) for e in prof.events()
           if e.name.startswith(timing.SPAN_PREFIX)]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def sweep(r, model):
    angles = np.float32([[0, a, 0] for a in (0, 90, 180, 270)])
    return r.render_sequence(model, angles, view_batch=2)


def test_span_enters_nothing_without_a_profiler(monkeypatch, cube):
    def refuse(*_args, **_kwargs):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert timing.span("render") is timing._NO_SPAN
    with timing.span("render") as entered:
        assert entered is None
    r = renderer()
    assert r.render(cube).get_image().max() > 0        # the frame path
    assert sweep(r, cube).shape == (4, SIZE, SIZE, 3)  # the sweep path


def test_span_is_a_profiler_range_while_one_runs():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        span = timing.span("bins")
        assert span is not timing._NO_SPAN
        with span:
            torch.ones(2).sum()
    assert [s[0] for s in program_spans(prof)] == ["bins"]


def test_a_frame_nests_its_stages_in_render(cube):
    r = renderer()
    r.render(cube)                                     # warm
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r.render(cube)
    spans = program_spans(prof)
    # the cube is untextured: its colours are drawn first
    assert [s[0] for s in spans] == ["render", "fallback_colors"] + FRAME_SPANS
    _name, lo, hi = spans[0]
    for (_n, a, b), (_m, c, _d) in zip(spans[1:], spans[2:] + [("", hi, hi)]):
        assert lo <= a <= b <= c <= hi                 # inside, in order


def test_a_sweep_nests_its_batches_in_sequence(cube):
    r = renderer(pt.NoIllumination())
    sweep(r, cube)                         # warm: B4's capacity holds both
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sweep(r, cube)
    spans = program_spans(prof)
    names = [s[0] for s in spans]
    assert names == ["sequence", "fallback_colors"] + 2 * [
        "front_end", "poses", "bins", "raster", "pair_total"]
    _name, lo, hi = spans[0]
    assert all(lo <= a <= b <= hi for _n, a, b in spans[1:])
    for i in (2, 7):                       # poses inside its batch's front end
        assert spans[i][1] <= spans[i + 1][1] <= spans[i + 1][2] <= spans[i][2]


@pytest.mark.parametrize("path", ["frame", "sweep"])
def test_spans_leave_the_output_unchanged(cube, path):
    def draw():                          # a fresh generator: the same colours
        r = renderer(pt.NoIllumination() if path == "sweep" else None)
        out = sweep(r, cube) if path == "sweep" else r.render(cube).get_image()
        return np.array(out)

    plain = draw()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = draw()
    assert program_spans(prof)                         # the spans were on
    assert plain.any() and np.array_equal(traced, plain)


def test_model_from_state_counts_its_seconds(cube):
    state = {"vertices": cube.vertices.numpy(),
             "faces_v": cube._faces_v.numpy(), "normals": cube.normals.numpy(),
             "faces_n": cube._faces_n.numpy()}
    seconds = timing.counters["model_state_s"]
    pt.Model.from_state(state, device="cpu")
    assert timing.counters["model_state_s"] > seconds


def test_kernel_load_counts_builds_and_seconds(monkeypatch, tmp_path):
    lib = tmp_path / "libstub.so"
    opened = object()
    monkeypatch.setattr(cuda_build, "_LIBS", {})
    monkeypatch.setattr(cuda_build, "library_path", lambda name: lib)
    monkeypatch.setattr(cuda_build, "compile_source",
                        lambda source, out: out.write_bytes(b"built"))
    monkeypatch.setattr(cuda_build, "open_library", lambda path: opened)
    keys = ("kernel_build_s", "kernel_load_s")
    before = [timing.counters[k] for k in keys]
    assert cuda_build.load("stub") is opened           # built, then loaded
    after = [timing.counters[k] for k in keys]
    assert after[0] > before[0] and after[1] > before[1]
    assert lib.read_bytes() == b"built"
    assert cuda_build.load("stub") is opened           # cached: not counted
    assert [timing.counters[k] for k in keys] == after
    monkeypatch.setattr(cuda_build, "compile_source", None)
    monkeypatch.setattr(cuda_build, "_LIBS", {})
    cuda_build.load("stub")                            # found built
    assert timing.counters["kernel_build_s"] > after[0]
