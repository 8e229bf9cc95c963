"""The traced window's arithmetic on hand-made events."""
import pytest

import tracing
from tracing import Trace


def test_union_merges_overlaps_and_touching():
    assert tracing.union([(5, 7), (0, 2), (1, 3), (3, 4), (9, 10)]) == [
        (0, 4), (5, 7), (9, 10)]
    assert tracing.union([]) == []


def make(device, host=(), window=(0.0, 100.0)):
    return Trace(list(host), list(device), window, steps=2, units=4,
                 unit="frame")


def test_busy_is_a_union_clipped_to_the_window():
    trace = make([("raster_kernel(int)", 10.0, 30.0),
                  ("void frontend_kernel<6>(float const*)", 20.0, 40.0),
                  ("Memset (Device)", 60.0, 70.0),
                  ("late", 95.0, 130.0),          # runs past the window
                  ("early", -20.0, -5.0)])        # before it: dropped
    assert trace.busy_s == pytest.approx((30 + 10 + 5) / 1e6)
    assert trace.window_s == pytest.approx(100 / 1e6)
    assert 1 - trace.busy_s / trace.window_s == pytest.approx(0.55)


def test_kernel_names_and_seconds():
    assert tracing.short_name("void frontend_kernel<6>(float const*, int)") \
        == "frontend_kernel"
    assert tracing.short_name("raster_kernel(float const*)") == "raster_kernel"
    assert tracing.short_name("(anonymous namespace)::raster_kernel(float "
                              "const*, int)") == "raster_kernel"
    assert tracing.short_name("void (anonymous namespace)::sort_coop_kernel"
                              "<4>(int*, int)") == "sort_coop_kernel"
    assert tracing.short_name("Memcpy DtoH (Device -> Pageable)") == \
        "Memcpy DtoH"
    assert tracing.short_name("void at::native::vectorized_elementwise_kernel"
                              "<4, ...>(int)") == "vectorized_elementwise_kernel"
    trace = make([("raster_kernel(int)", 0.0, 3.0),
                  ("raster_kernel(int)", 10.0, 12.0),
                  ("scan_kernel(int*)", 20.0, 21.0)])
    assert trace.kernel_count({"raster_kernel"}) == 2
    assert trace.kernel_seconds({"raster_kernel"}) == pytest.approx(5e-6)
    trace.bounds = {"raster": 1e-6}
    assert trace.roofline("raster", {"raster_kernel"}) == pytest.approx(20.0)
    assert trace.roofline("f1", {"frontend_kernel"}) is None


def test_host_calls_inside_a_stage_and_gaps():
    host = [("stage:frame", 0.0, 50.0), ("stage:bins", 10.0, 20.0),
            ("cudaStreamSynchronize", 15.0, 16.0),
            ("cudaStreamSynchronize", 60.0, 61.0),
            ("cudaLaunchKernel", 12.0, 13.0), ("cudaLaunchKernel", 150.0, 151.0)]
    trace = make([("a", 30.0, 40.0), ("b", 70.0, 80.0)], host)
    assert trace.host_calls({"cudaStreamSynchronize"}) == 2
    assert trace.host_calls({"cudaStreamSynchronize"}, inside="frame") == 1
    assert trace.host_calls({"cudaLaunchKernel"}) == 1     # 150 is outside
    gaps = trace.breakdown()["idle_gaps"]
    assert [g[1] for g in gaps] == pytest.approx([30e-6, 30e-6, 20e-6])
    # 0..30: its middle lies in bins, the innermost range; 40..70 and
    # 80..100 lie outside every stage
    assert [g[0] for g in gaps] == ["stage:bins", "harness", "harness"]
    ops = trace.breakdown()["device_ops"]
    assert ops == [["a", pytest.approx(10e-6)], ["b", pytest.approx(10e-6)]]



def traced(monkeypatch, seen):
    """``harness.traced_window`` over 4 steps of a stub loop whose step
    launches one raster_kernel, with the profiler replaced: take k sees
    ``seen[k]`` raster_kernel events. Returns (result, steps of each take)."""
    import contextlib

    import torch
    import torch.profiler

    import harness

    class Profile:
        def __init__(self, **_kwargs):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    taken = []

    def from_profiler(prof, steps, units, unit):
        taken.append(steps)
        return make([("raster_kernel(int)", 1.0, 2.0)] * seen[len(taken) - 1])

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(tracing, "stage_targets", lambda: [])
    monkeypatch.setattr(tracing, "stage_ranges",
                        lambda targets: contextlib.nullcontext())
    monkeypatch.setattr(Trace, "from_profiler", staticmethod(from_profiler))
    driver = type("D", (), {"kernels_per_step": {"raster_kernel": 1},
                            "unit": "frame",
                            "units": staticmethod(lambda out: 1)})()
    loop = type("L", (), {"driver": driver,
                          "step": staticmethod(lambda: (0, None))})()
    try:
        return harness.traced_window(loop, 4, torch.device("cuda"),
                                     log=lambda m: None), taken
    except RuntimeError as exc:
        return exc, taken


def test_a_window_that_loses_kernels_on_every_take_fails(monkeypatch):
    """No per-layer metric is read from a trace that lacks its kernels:
    after the last take the traced window raises instead."""
    result, taken = traced(monkeypatch, [3, 0, 0])
    assert isinstance(result, RuntimeError)
    assert "lost kernel events" in str(result)
    assert taken == [4, 4, 4]


def test_a_retake_that_sees_every_kernel_is_kept(monkeypatch):
    (trace, keys), taken = traced(monkeypatch, [3, 4, 0])
    assert trace.kernel_count({"raster_kernel"}) == 4
    assert keys == [0] * 4 and taken == [4, 4]
