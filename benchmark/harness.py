"""One run of one cell: set-up, the measured window, the traced window,
the comparison with the reference, and the result line.

Everything that belongs to one configuration, traffic mix or metric is
found by name: the cell's entry in ``BENCHMARK.json`` names its
configuration (``configs/<config>.json``) and traffic mix
(``mixes/<traffic>.json``); the mix names its driver
(``drivers/<driver>.py``); each metric is read by ``endtoend/<name>.py``
or ``metrics/<name>.py``.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import random
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

import tracing
from reference import compare

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level modules that must not be loaded: JAX and the JAX package
FORBIDDEN = frozenset(("jax", "jaxlib", "flax", "cython3dmodelrenderer_tpu"))
#: steps run under the profiler before its window opens
PROFILER_WARM_STEPS = 3
#: takes of the traced window when the profiler lost kernel events
TRACE_TAKES = 3


def load_module(path: Path):
    """Import the Python file at ``path`` (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "bench_" + path.stem.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def catalog(shelved: bool = False) -> dict:
    """``BENCHMARK.json``; with ``shelved``, also the entries of
    ``shelved.json``: cells that run and are correct but are left out of
    the benchmark (PERF.md, Open questions), which a later PR adds to
    ``BENCHMARK.json`` as they are."""
    bench = read_json(ROOT / "BENCHMARK.json")
    if shelved:
        for key, entries in read_json(HERE / "shelved.json").items():
            bench[key] = bench[key] + entries
    return bench


class Cell:
    """A cell of ``BENCHMARK.json`` with its files and metrics."""

    def __init__(self, name: str, bench: dict, home: Path = HERE):
        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name, self.entry = name, entries[name]
        self.chips = int(self.entry["chips"])
        self.config = read_json(home / "configs" / f"{self.entry['config']}.json")
        self.traffic = read_json(home / "mixes" / f"{self.entry['traffic']}.json")
        self.driver_path = home / "drivers" / f"{self.traffic['driver']}.py"
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m["workloads"]]
        self.home = home

    def reader(self, metric: dict, layer: bool):
        folder = "metrics" if layer else "endtoend"
        return load_module(self.home / folder / f"{metric['name']}.py")


def synchronizer(device: torch.device):
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


class Loop:
    """Runs steps of a driver and keeps a seeded sample of their outputs:
    for each key, one output drawn uniformly from those it produced."""

    def __init__(self, driver, device: torch.device, seed: int):
        self.driver, self.sync = driver, synchronizer(device)
        self.rng = random.Random(seed)
        self.kept, self.seen = {}, {}
        self.i = 0

    def step(self):
        key, out = self.driver.step(self.i)
        self.sync()
        self.i += 1
        n = self.seen[key] = self.seen.get(key, 0) + 1
        if self.rng.random() * n < 1.0:
            self.kept[key] = out
        return key, out

    def window(self, seconds: float):
        """Steps until ``seconds`` have passed and every key has had a
        step; (seconds, units, latencies) over whole steps, the last one
        ending past the deadline."""
        latencies, units, per_second = [], 0, []
        keys = len(self.driver.keys())
        start = time.perf_counter()
        deadline = start + seconds
        end = start
        while end < deadline or len(self.seen) < keys:
            t0 = time.perf_counter()
            _key, out = self.step()
            end = time.perf_counter()
            latencies.append(end - t0)
            n = self.driver.units(out)
            units += n
            second = int(end - start)
            per_second.extend([0] * (second + 1 - len(per_second)))
            per_second[second] += n
        self.per_second = per_second
        return end - start, units, latencies


def traced_window(loop: Loop, steps: int, device: torch.device, log):
    """``steps`` steps under the profiler inside a ``bench:window`` range,
    taken again when the profiler lost kernel events; (Trace, keys).
    Raises when every take lost some: no metric is read from such a
    trace."""
    from torch.profiler import ProfilerActivity, profile, record_function

    driver = loop.driver
    targets = tracing.stage_targets()
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    for take in range(1, TRACE_TAKES + 1):
        keys, units = [], 0
        with tracing.stage_ranges(targets), profile(activities=activities) as prof:
            for _ in range(PROFILER_WARM_STEPS):
                loop.step()
            with record_function(tracing.WINDOW):
                for _ in range(steps):
                    key, out = loop.step()
                    keys.append(key)
                    units += driver.units(out)
        trace = tracing.Trace.from_profiler(prof, steps=steps, units=units,
                                            unit=driver.unit)
        if device.type != "cuda":
            return trace, keys
        lost = {name: (trace.kernel_count({name}), per * steps)
                for name, per in driver.kernels_per_step.items()
                if trace.kernel_count({name}) != per * steps}
        if not lost:
            return trace, keys
        log(f"traced window take {take}: the profiler lost kernel events "
            f"(seen, launched): {lost}")
    raise RuntimeError(f"every one of {TRACE_TAKES} traced windows lost "
                       "kernel events")


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def run(cell_name: str, seed: int, seconds: float, trace: bool, *,
        started: float, device="cuda", config_overrides=None,
        traffic_overrides=None, control=None, shelved=False,
        log=lambda msg: print(msg, file=sys.stderr, flush=True)):
    """One run; returns the result line's object. ``failed`` counts the
    sampled steps whose output differs from the reference.

    ``started`` is the ``time.perf_counter()`` of the process's start.
    ``control``: a dtype to put the reference, computed in it, in the
    program's place. The overrides update the configuration's and the
    traffic's top-level keys (small shapes for tests on the CPU);
    ``shelved`` lets ``cell_name`` be a shelved cell (``catalog``)."""
    device = torch.device(device)
    cell = Cell(cell_name, catalog(shelved))
    cell.config.update(config_overrides or {})
    cell.traffic.update(traffic_overrides or {})
    driver = load_module(cell.driver_path).Driver(cell.config, cell.traffic,
                                                  seed, device)
    if control is None:
        driver.build_program()
    else:
        driver.build_control(control)
    driver.warm()
    synchronizer(device)()
    setup_s = time.perf_counter() - started

    loop = Loop(driver, device, seed)
    window_s, units, latencies = loop.window(seconds)
    window = SimpleNamespace(seconds=window_s, units=units, unit=driver.unit,
                             latencies=latencies, setup_s=setup_s)
    log(f"window: {units} {driver.unit}s in {window_s:.3f} s after "
        f"{setup_s:.3f} s of set-up; {driver.unit}s each second: "
        f"{loop.per_second}")
    traced = keys_traced = None
    if trace:
        traced, keys_traced = traced_window(
            loop, int(cell.traffic["trace_steps"]), device, log)
        traced.seconds_per_unit = window_s / units
    attempted = loop.i
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)

    # the program's state goes before the reference runs
    kept = loop.kept
    driver.release()
    del loop
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    worst = failed = compared = expected = 0
    stats = {}
    for key in driver.keys():
        expected += driver.images_per_key
        if key not in kept:
            continue
        refs = driver.reference(key)
        stats[key] = [st for _img, st in refs]
        px = [compare.mismatched_pixels(image, ref) for image, (ref, _st)
              in zip(driver.images(kept.pop(key)), refs)]
        worst = max([worst] + px)
        failed += max(px) > compare.LIMITS["worst_image_px"]
        compared += len(px)
    checks = {"worst_image_px": (worst, compare.LIMITS["worst_image_px"]),
              "images_missing": (expected - compared,
                                 compare.LIMITS["images_missing"])}

    metrics = {}
    if trace:
        sums: dict = {}
        for key in keys_traced:
            for group, s in driver.bounds(stats[key]).items():
                sums[group] = sums.get(group, 0.0) + s
        traced.bounds = sums
        specs, source = cell.per_layer, traced
    else:
        specs, source = cell.end_to_end, window
    for spec in specs:
        value = cell.reader(spec, trace).read(source)
        if value is None and not trace:
            raise RuntimeError(f"{spec['name']} read nothing in {cell_name}")
        if value is not None:
            metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}

    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
                "count": cell.chips, "memory_peak_bytes": memory_peak}
    result = {"correct": all(v <= lim for v, lim in checks.values()),
              "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": dev_info}
    if trace:
        dev_info.update(busy_s=traced.busy_s, window_s=traced.window_s)
        result["breakdown"] = traced.breakdown()
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result
