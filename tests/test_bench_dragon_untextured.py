"""The cells ``dragon871k.frames1024`` and ``igor6k.untextured_frames1024``
on the CPU at small shapes, through ``harness.run`` as
``benchmark/tests/test_bench_correct.py`` drives it: sound runs are
correct, the control (the reference in bfloat16 in the program's place)
and faults planted in the fallback colours are not; the Dragon
configuration's scale; the reader ``fallback_host_us.frames``."""
import json
import sys
import time
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

BENCH = Path(__file__).resolve().parent.parent / "benchmark"
sys.path[:0] = [str(BENCH)]

import harness  # noqa: E402
import tracing  # noqa: E402
from reference import meshes  # noqa: E402

import cython3dmodelrenderer_tpu_torch as pt  # noqa: E402

CELLS = ["dragon871k.frames1024", "igor6k.untextured_frames1024"]
SMALL_MESH = {"dragon871k": {"builder": "displaced_torus", "nu": 24, "nv": 12},
              "igor6k": {"builder": "displaced_sphere", "segments": 16,
                         "rings": 10}}
SMALL_TRAFFIC = {"size": 80, "poses": 4, "trace_steps": 2}
#: the Stanford Dragon's triangles (dragon_vrip.ply)
DRAGON_TRIANGLES = 871414
FALLBACK = "fallback_host_us.frames"


def small_run(cell, seed=2 ** 33 + 7, trace=False, control=None):
    """One run at a small size, on one host thread as ``run.py`` runs it;
    the window is long enough for ``frame_p95_ms``'s 20 frames on a
    loaded CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return harness.run(
            cell, seed, 3.0, trace, started=time.perf_counter(), device="cpu",
            config_overrides={"mesh": SMALL_MESH[cell.split(".")[0]]},
            traffic_overrides=SMALL_TRAFFIC, control=control,
            log=lambda m: None)
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    result = small_run(cell)
    assert result["correct"], result["checks"]
    assert result["checks"]["worst_image_px"]["value"] == 0
    assert result["checks"]["images_missing"]["value"] == 0
    assert result["attempted"] > 0 and result["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_its_metrics(cell):
    result = small_run(cell, trace=True)
    assert result["correct"]
    metrics = result["metrics"]
    assert "launch_calls.frames" in metrics and "glue_host_us.frames" in metrics
    assert (FALLBACK in metrics) == ("untextured" in cell)


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    result = small_run(cell, control=torch.bfloat16)
    assert not result["correct"]
    assert result["checks"]["worst_image_px"]["value"] > 0


def white_colors(monkeypatch):
    """White in place of random colours."""
    fallback = pt.Renderer._fallback_colors
    monkeypatch.setattr(pt.Renderer, "_fallback_colors",
                        lambda self, model, _random: fallback(self, model,
                                                              False))


def reseeded_generator(monkeypatch):
    """The generator seeded otherwise than the step seeded it."""
    fallback = pt.Renderer._fallback_colors

    def reseeded(self, model, random_colors):
        self.generator.manual_seed(self.generator.initial_seed() + 1)
        return fallback(self, model, random_colors)
    monkeypatch.setattr(pt.Renderer, "_fallback_colors", reseeded)


@pytest.mark.parametrize("fault", [white_colors, reseeded_generator],
                         ids=lambda f: f.__name__)
def test_fault_in_the_fallback_colours_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    result = small_run("igor6k.untextured_frames1024")
    assert not result["correct"], result["checks"]


def test_dragon_configuration_is_the_sources_scale():
    config = json.loads((BENCH / "configs" / "dragon871k.json").read_text())
    vertices, faces = meshes.build(config["mesh"])
    assert faces.shape == (871824, 3) == (config["triangles"], 3)
    assert len(vertices) == 435912
    assert faces.min() == 0 and faces.max() == len(vertices) - 1
    assert abs(len(faces) / DRAGON_TRIANGLES - 1) < 1e-3
    assert config["reduced"] == []
    entry = {c["name"]: c for c in harness.catalog()["configs"]}["dragon871k"]
    assert entry["reduced"] == [] and entry["source"] == config["source"]


def test_new_cells_report_the_frame_metrics():
    bench = harness.catalog()
    for cell in CELLS:
        c = harness.Cell(cell, bench)
        assert c.chips == 1
        assert {m["name"] for m in c.end_to_end} == {"frame_ms",
                                                     "frame_p95_ms", "setup_s"}
        assert {m["name"] for m in c.per_layer} == {
            m["name"] for m in bench["per_layer"]
            if "igor6k.frames1024" in m["workloads"]} | (
                {FALLBACK} if "untextured" in cell else set())


def reader():
    return harness.load_module(BENCH / "metrics" / f"{FALLBACK}.py")


def span(stage, a, b):
    return (f"stage:crender.{stage}", a, b)


def test_fallback_reader_on_a_hand_made_window():
    host = [span("render", -300.0, -100.0),        # before the window
            span("fallback_colors", -290.0, -280.0),
            span("render", 100.0, 300.0), span("fallback_colors", 105.0, 125.0),
            span("front_end", 130.0, 160.0),
            span("render", 500.0, 700.0), span("fallback_colors", 502.0, 537.0)]
    trace = tracing.Trace(host, [("raster_kernel", 200.0, 260.0)],
                          (0.0, 1000.0), steps=2, units=2, unit="frame")
    assert reader().read(trace) == pytest.approx((20.0 + 35.0) / 2, rel=1e-12)
    textured = [e for e in host if "fallback" not in e[0]]
    assert reader().read(tracing.Trace(textured, [], (0.0, 1000.0), steps=2,
                                       units=2, unit="frame")) is None
    assert reader().read(tracing.Trace(host, [], (0.0, 1000.0), steps=2,
                                       units=2, unit="view")) is None


@pytest.fixture
def models(cube_path):
    """The untextured cube and the same cube with one colour a vertex."""
    cube = pt.Model.read_model(cube_path, device="cpu")
    cube.rotate([30, 40, 0])
    pt.fit_model(cube)
    faces = cube._faces_v.numpy()
    state = {"vertices": cube.vertices.numpy(), "faces_v": faces,
             "normals": cube.normals.numpy(), "faces_n": cube._faces_n.numpy(),
             "colors": torch.full((len(cube.vertices), 3), 200.0).numpy(),
             "faces_vt": faces}
    return {"untextured": cube,
            "textured": pt.Model.from_state(state, device="cpu")}


@pytest.mark.parametrize("kind", ["untextured", "textured"])
def test_fallback_reader_on_real_frames(models, kind):
    filler = pt.AdvancedPixelBufferFiller(64, 64, fov=60, backend="torch",
                                          device="cpu")
    r = pt.Renderer(filler, pt.GuroIllumination([0, 0, 1]), pt.SimpleIterator,
                    64, 64)
    frames = 3
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r.render(models[kind])                      # before the window
        with record_function(tracing.WINDOW):
            for _ in range(frames):
                r.render(models[kind])
    trace = tracing.Trace.from_profiler(prof, steps=frames, units=frames,
                                        unit="frame")
    value = reader().read(trace)
    if kind == "textured":
        assert value is None
    else:
        assert isinstance(value, float) and value > 0.0
