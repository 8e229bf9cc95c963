"""The benchmark's readers of the port's own spans and counters
(``benchmark/program_spans.py`` and eight files of ``benchmark/metrics/``):
exact arithmetic on a hand-made traced window, None where the program
gives nothing to read, and a number from each on a CPU profiler trace of
real frames."""
import sys
from collections import Counter
from pathlib import Path

import pytest
from torch.profiler import ProfilerActivity, profile, record_function

BENCH = Path(__file__).resolve().parent.parent / "benchmark"
sys.path[:0] = [str(BENCH)]

import harness  # noqa: E402
import tracing  # noqa: E402

import cython3dmodelrenderer_tpu_torch as pt  # noqa: E402
from cython3dmodelrenderer_tpu_torch.utils import timing  # noqa: E402

SPAN_READERS = ["glue_host_us.frames", "front_end_host_us.frames",
                "total_wait_us.frames", "bins_host_us.frames",
                "raster_host_us.frames", "idle_in_program.frames"]
SETUP_READERS = ["setup_kernels_s", "setup_models_s"]
#: the readers whose sum is the mean duration of a frame's ``render`` span
#: (an untextured model's, which draws its fallback colours)
ACCOUNTING = SPAN_READERS[:5] + ["fallback_host_us.frames"]


def reader(name):
    return harness.load_module(BENCH / "metrics" / f"{name}.py")


def span(stage, a, b):
    return (f"stage:crender.{stage}", a, b)


#: two frames of 200 µs each in a 1000-µs window, with the harness's own
#: ranges around them and a span before the window (a warm step)
HOST = [span("render", -300.0, -100.0), span("front_end", -290.0, -250.0),
        ("stage:frame", 90.0, 310.0), ("stage:render_frame", 105.0, 270.0),
        span("render", 100.0, 300.0), span("front_end", 110.0, 150.0),
        span("poses", 115.0, 130.0), span("pair_total", 150.0, 170.0),
        span("bins", 175.0, 220.0), ("cudaLaunchKernel", 180.0, 181.0),
        span("raster", 230.0, 260.0),
        span("render", 500.0, 700.0), span("front_end", 510.0, 560.0),
        span("pair_total", 560.0, 600.0), span("bins", 600.0, 650.0),
        span("raster", 650.0, 680.0)]
DEVICE = [("frontend_kernel", 140.0, 160.0),
          ("sort_coop_kernel", 200.0, 240.0), ("raster_kernel", 560.0, 620.0)]


def hand_made(host=HOST, unit="frame"):
    return tracing.Trace(list(host), list(DEVICE), (0.0, 1000.0), steps=2,
                         units=2, unit=unit)


@pytest.mark.parametrize("name,want", [
    # self time: 200 - (40 + 20 + 45 + 30) and 200 - (50 + 40 + 50 + 30);
    # poses lies inside front_end and takes nothing more
    ("glue_host_us.frames", (65.0 + 30.0) / 2),
    ("front_end_host_us.frames", (40.0 + 50.0) / 2),
    ("total_wait_us.frames", (20.0 + 40.0) / 2),
    ("bins_host_us.frames", (45.0 + 50.0) / 2),
    ("raster_host_us.frames", (30.0 + 30.0) / 2),
    # idle: [0,140] [160,200] [240,560] [620,1000] = 880 µs; in the two
    # frames: 40 + 40 + 60 + 60 + 80 = 280 µs
    ("idle_in_program.frames", 100.0 * 280.0 / 880.0),
])
def test_span_readers_on_a_hand_made_window(name, want):
    assert reader(name).read(hand_made()) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", SPAN_READERS)
def test_span_readers_read_nothing_without_spans(name):
    harness_only = [e for e in HOST if not e[0].startswith("stage:crender.")]
    assert reader(name).read(hand_made(harness_only)) is None
    assert reader(name).read(hand_made(unit="view")) is None


def test_overlap_of_interval_lists():
    import program_spans

    assert program_spans.overlap([(0, 10), (20, 30)], [(5, 25)]) == 10
    assert program_spans.overlap([(0, 10)], []) == 0
    assert program_spans.overlap([(0, 1), (2, 3)], [(0, 1), (2, 3)]) == 2


def test_setup_readers_read_the_counters(monkeypatch):
    monkeypatch.setattr(timing, "counters", Counter(
        kernel_build_s=1.25, kernel_load_s=0.5, model_state_s=0.75))
    assert reader("setup_kernels_s").read(None) == 1.75
    assert reader("setup_models_s").read(None) == 0.75
    monkeypatch.delattr(timing, "counters")        # a program without them
    for name in SETUP_READERS:
        assert reader(name).read(None) is None


def test_every_reader_reads_real_frames(cube_path):
    model = pt.Model.read_model(cube_path, device="cpu")
    model.rotate([30, 40, 0])
    pt.fit_model(model)
    filler = pt.AdvancedPixelBufferFiller(64, 64, fov=60, backend="torch",
                                          device="cpu")
    r = pt.Renderer(filler, pt.GuroIllumination([0, 0, 1]), pt.SimpleIterator,
                    64, 64)
    frames = 3
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r.render(model)                             # before the window
        with record_function(tracing.WINDOW):
            for _ in range(frames):
                r.render(model)
    trace = tracing.Trace.from_profiler(prof, steps=frames, units=frames,
                                        unit="frame")
    got = {name: reader(name).read(trace)
           for name in SPAN_READERS + SETUP_READERS + ACCOUNTING[5:]}
    assert all(isinstance(v, float) for v in got.values()), got
    assert 0.0 < got["idle_in_program.frames"] <= 100.0
    renders = [b - a for n, a, b in trace.host
               if n == "stage:crender.render"
               and trace.window[0] <= a <= trace.window[1]]
    assert len(renders) == frames
    assert sum(got[n] for n in ACCOUNTING) == pytest.approx(
        sum(renders) / frames, rel=1e-9)
