"""Profile steady-state frames of the PyTorch port on a CUDA GPU.

Run from the repository root on a machine with an NVIDIA GPU:

    python tools/profile_torch_frame.py [--scene sphere16k|torus262k]
        [--textured] [--size 1024] [--frames 20] [--out DIR]
        [--backend auto|ratio]
        [--sweep 1,2,4,8] [--b5] [--binning] [--raster [SOURCE.cu ...]]
        [--rounds 4] [--p1 [PRIM ...]] [--sharded]
        [--frontend [SOURCE.cu ...]] [--span-cost CELL [--seed N]]

Renders a scene of ``chip_smoke.py`` (the 16,128-triangle displaced UV
sphere, or the 262,144-triangle displaced torus) at ``--size``² with
GuroIllumination and NoIllumination through ``Renderer.render``, traces
``--frames`` warm frames with ``torch.profiler``, and prints per frame:
wall time, summed device-kernel time, the number of device operations,
the host's launch calls by stage, the kernels ranked
by device time, the host operations (with their input shapes) that
launched the most device time, and the spread of ``--frames`` frames
timed one by one without the profiler (host clock, each fenced by a
synchronize); ``--backend ratio`` profiles the frames of the ratio-form
rasterizer. The
stages are the program's own spans (``utils/timing.py::span``): front
end (F1's launch; in a sweep the host's poses apart), pair total (the
host read), bins, raster, and the glue, the rest of ``Renderer.render``
or ``render_sequence``; each launch call counts in the innermost span
around it, and as "outside" in a tree without the spans. The device's
idle share is the benchmark's ``device_idle.frames`` (a ``--trace 1``
run of ``benchmark/run.py``). ``--textured`` renders the scene with a
seeded colour a vertex (``chip_smoke.textured``), as the benchmark's
frame cells do, instead of the fallback colours.
``--sweep`` traces instead ``--frames`` sweeps of ``chip_smoke.py``'s
8-view turntable through ``Renderer.render_sequence`` at each listed
view_batch (numbers per view); ``--b5`` traces ``--frames`` calls of
B5's wrapper on the scene's spans (group 16, sub 8) at chip_smoke.py's
ample and undersized slot_caps, and prints the wrapper's and the plain
version's CUDA-event ms a call; ``--p1`` prints, for each primitive of
P1 (default all 15), device ms and device operations a call
(``measure.profile_calls``) at 128 and 256 replicas, µs per replica from
their difference, and the event-timed slope of ``probes.epi_prims.measure``,
then traces epi_cur6 x 128 by kernel. ``--b5`` and ``--p1`` use only the
wrappers' public calls, so the same command runs in a ``git archive`` copy
of the parent commit (with this file and ``measure.py`` copied in) to
compare the two in turns; ``--binning`` traces ``--frames`` calls of each binning route on the
scene's lambert_u8 spans (``binsort.bin_sort``, and ``binsort.bin_pairs``
where the pair key fits in 31 bits): device operations and device ms a
call. ``--raster`` times kernel B1 (``raster_tiles``) on the lambert_u8
inputs ``chip_smoke.py`` times it on: sphere16k@1024², torus262k@1024²
(the B3 route) and the 2-view sweep batch, each on B4's bins. It takes the
repository's ``csrc/raster.cu`` and each extra SOURCE.cu that exports the
same ``raster_launch`` (for example the parent commit's, unpacked with
``git archive``), built with the repository's nvcc flags, and measures
device ms and device operations a call (``measure.profile_calls``)
``--rounds`` times in turns (A B B A ...), after checking each library's
image against ``raster_tiles_plain``. ``--sharded`` traces, at world
size 1 in this process (NCCL), ``--frames`` triangle-sharded frames of the
scene (``render_triangle_sharded``, the merge's four all-reduces
included) beside the unsharded G-buffer frame they merge.
``--frontend`` times kernel F1 (``frame_planes``) on the inputs
``chip_smoke.py`` times it on: sphere16k@1024² and torus262k@1024² at 6
and 3 channels and the sweep's posed 4-view batch at 6, after checking
every output against ``frame_planes_plain`` bit for bit: device ms and
device operations a call (``measure.profile_calls``) ``--rounds`` times,
CUDA-event ms a call, and the bound. With no SOURCE it uses only the
wrapper's public call, so the same command runs in a ``git archive`` copy
of the parent commit (with this file copied in) to compare the two in
turns; each SOURCE.cu that exports the same ``frontend_launch`` and
``frontend_constants`` (a variant of ``csrc/frontend.cu``, say with
another block size) is built like ``--raster``'s and timed in turns with
the repository's kernel, the wrapper sized by the variant's own block.
``--span-cost CELL`` measures what the program's spans cost a frame of a
frame cell of the benchmark (``BENCHMARK.json``; its driver in
``benchmark/drivers``, ``--seed``), in the loop of its ``--trace 1`` run:
the harness's stage ranges on, each frame fenced by a synchronize. Under
one profiler session it takes ``--rounds`` pairs of blocks of ``--frames``
frames, one block with the spans and one with ``utils.timing.span``
replaced here by its no-op (the gate shut), in turns (A B B A ...), so
that a drift of the host's speed falls on both alike. It prints the host
µs a frame of every block, of ``--rounds`` untraced blocks before them,
the pairs' differences (spans less gate shut: median, quartiles, how many
are positive), the µs from the start of the harness's ``stage:frame``
range to the program's ``render`` span and from that span's end to the
range's end, and the µs of one span's enter and exit with and without
the profiler.
The chrome traces go to ``--out`` (default ``build/profile``).
"""
import argparse
import collections
import contextlib
import ctypes
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke  # noqa: E402
import cython3dmodelrenderer_tpu_torch as pt  # noqa: E402
from cython3dmodelrenderer_tpu_torch.measure import (  # noqa: E402
    device_entries, device_us, smi)


#: host calls that enqueue device work (the CUDA runtime and `cu*` calls)
LAUNCH_CALLS = frozenset((
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
    "cuLaunchKernelEx", "cudaLaunchCooperativeKernel", "cudaMemsetAsync",
    "cudaMemcpyAsync", "cudaMemset", "cudaMemcpy"))
#: the program's spans (``utils/timing.py::span``)
SPAN_PREFIX = "stage:crender."
#: a span's stage -> the label of the launch calls innermost in it; "glue"
#: is the rest of a frame (``render``) or a sweep (``sequence``)
STAGE_LABELS = {"render": "glue", "sequence": "glue", "front_end": "front end",
                "poses": "poses", "pair_total": "pair total", "bins": "bins",
                "raster": "raster"}


def op_device_ms(prof, n, top=8):
    """The ``top`` host operations by the device time of the kernels they
    launched themselves, grouped by input shapes: ms and calls a frame."""
    def self_us(e):
        return next((v for a in ("self_device_time_total",
                                 "self_cuda_time_total")
                     if (v := getattr(e, a, None))), 0.0)

    ops = [e for e in prof.key_averages(group_by_input_shape=True)
           if str(e.device_type).endswith("CPU") and self_us(e) > 0
           and not e.key.startswith("stage:")]
    return [{"op": e.key, "shapes": str(e.input_shapes)[:80],
             "ms": self_us(e) / n / 1e3, "calls": e.count / n}
            for e in sorted(ops, key=lambda e: -self_us(e))[:top]]


def stage_launches(prof, n):
    """Host launch calls a frame (or view) by stage: each counted in the
    innermost program span around its start ("outside" where none is, as
    in a tree without the spans)."""
    events = [e for e in prof.events() if str(e.device_type).endswith("CPU")]
    ranges = [(e.time_range.start, e.time_range.end,
               e.name[len(SPAN_PREFIX):])
              for e in events if e.name.startswith(SPAN_PREFIX)]
    counts = collections.Counter()
    for e in events:
        if e.name not in LAUNCH_CALLS:
            continue
        t = e.time_range.start
        inner = [r for r in ranges if r[0] <= t <= r[1]]
        stage = (min(inner, key=lambda r: r[1] - r[0])[2] if inner
                 else "outside")
        counts[STAGE_LABELS.get(stage, stage)] += 1
    return {k: v / n for k, v in sorted(counts.items())}


def spread(fn, reps, per):
    """ms per call / ``per`` of ``reps`` calls timed one by one (host clock,
    each fenced by a synchronize), without the profiler."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / per * 1e3)
    q = statistics.quantiles(times, n=4) if len(times) > 1 else times * 3
    return {"median": statistics.median(times), "q1": q[0], "q3": q[2],
            "min": min(times), "max": max(times), "n": reps}


def trace(label, fn, reps, per, out, stages=False):
    """Profile ``reps`` warm calls of ``fn``; print per-``per`` numbers
    (``stages``: the launch calls by stage, and the unprofiled spread)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=stages) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / (reps * per) * 1e3
    prof.export_chrome_trace(os.path.join(out, f"{label.replace('/', '_')}.json"))
    # the spans' device-side annotations cover whole stages: not work
    kernels = [e for e in device_entries(prof)
               if not e.key.startswith("stage:")]
    n = reps * per
    dev = sum(device_us(e) for e in kernels) / n / 1e3
    top = sorted(kernels, key=lambda e: -device_us(e))[:12]
    result = {
        "frame": label, "wall_ms": wall, "device_ms": dev,
        "kernel_launches": sum(e.count for e in kernels) / n,
        "top": [{"kernel": e.key[:80], "ms": device_us(e) / n / 1e3,
                 "calls": e.count / n} for e in top]}
    if stages:
        result["top_ops"] = op_device_ms(prof, n)
        result["stage_launch_calls"] = stage_launches(prof, n)
        result["launch_calls"] = sum(result["stage_launch_calls"].values())
        result["spread_ms"] = spread(fn, reps, per)
    print(json.dumps(result))
    print(prof.key_averages().table(sort_by="self_cpu_time_total",
                                    row_limit=15))


def build_variant(source, bind):
    """nvcc ``source`` (a variant of one of ``csrc/``'s kernels, exporting
    the same C functions) with the repository's flags into
    ``build/kernels/variants``; return it loaded and bound by ``bind``."""
    import hashlib
    from pathlib import Path

    from cython3dmodelrenderer_tpu_torch import cuda_build

    source = Path(source)
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    out = cuda_build.BUILD_DIR / "variants" / f"lib{source.stem}-{digest}.so"
    report = cuda_build.compile_source(source, out)
    print(f"built {source}: " + " / ".join(
        ln.split("ptxas info    :")[-1].strip()
        for ln in report.splitlines() if "Used" in ln or "spill" in ln))
    return bind(cuda_build.open_library(out))


def scene_model(name):
    """``chip_smoke.py``'s sphere16k or torus262k, posed, on the card."""
    v, f = (chip_smoke.displaced_sphere(chip_smoke.TRI_SPHERE_SEGMENTS,
                                        chip_smoke.TRI_SPHERE_RINGS)
            if name == "sphere16k"
            else chip_smoke.displaced_torus(*chip_smoke.TORUS_QUADS))
    return chip_smoke.posed(pt.Model(v, f, device="cuda"), True)


def turntable_inputs():
    """The sweep's centred sphere16k and seeded colours (T, 3, 3)."""
    gen = torch.Generator().manual_seed(7)
    centred = chip_smoke.turntable_model("cuda")
    colors = torch.randint(256, (centred.n_triangles(), 3), generator=gen)
    colors = colors.to("cuda", torch.float32)[:, None, :].expand(-1, 3, 3)
    return centred, colors.contiguous()


def raster_inputs(sphere, torus):
    """B1's lambert_u8 inputs, as ``chip_smoke.py`` times them."""
    from cython3dmodelrenderer_tpu_torch.ops import raster

    out = {}
    for tag, model in (("sphere16k@1024", sphere), ("torus262k@1024", torus)):
        kw, (tx0, cx, ty0, cy, ntx, nty, total) = chip_smoke.frame_setup(
            model, "lambert_u8", 1024)
        out[tag] = chip_smoke.with_bins(kw, raster.route_bins(
            tx0, cx, ty0, cy, ntx, nty, total, "cuda"))
    out["sweep vb2"] = chip_smoke.sweep_batch_inputs(*turntable_inputs(),
                                                     "lambert_u8")
    return out


def raster_ab(sources, rounds):
    """Device ms a call of B1 for the repository's kernel and each source."""
    from cython3dmodelrenderer_tpu_torch.measure import profile_calls
    from cython3dmodelrenderer_tpu_torch.ops import raster

    libs = [("repo", raster._lib())]
    libs += [(src, build_variant(src, raster.bind)) for src in sources]
    sphere, torus = scene_model("sphere16k"), scene_model("torus262k")
    light = pt.GuroIllumination([0, 0, 1]).light_direction
    repo_lib = raster._lib
    try:
        for tag, kw in raster_inputs(sphere, torus).items():
            opts = dict(light=light, gbuffer=False, image=True)
            want = raster.raster_tiles_plain(**kw, **opts)[1]

            def call():
                return raster.raster_tiles(**kw, **opts)[1]

            for name, lib in libs:
                raster._lib = lambda lib=lib: lib
                equal = torch.equal(call(), want) and torch.equal(call(), want)
                print(f"{tag} {name}: image == raster_tiles_plain, twice: "
                      f"{equal}")
            ms = {name: [] for name, _lib in libs}
            for r in range(rounds):
                for name, lib in (libs if r % 2 == 0 else libs[::-1]):
                    raster._lib = lambda lib=lib: lib
                    ms[name].append(profile_calls(call, 20))
            print(json.dumps({"raster": tag, "pairs": int(kw["pair_tri"].numel()),
                              "device_ms_ops": ms}))
    finally:
        raster._lib = repo_lib


def b5(model, size, frames, out):
    """B5's wrapper at chip_smoke.py's ample and undersized caps."""
    from cython3dmodelrenderer_tpu_torch.measure import cuda_time_ms
    from cython3dmodelrenderer_tpu_torch.ops import binsort_grouped as bg

    spans = chip_smoke.frame_setup(model, "lambert_u8", size)[1]
    total, spans = spans[-1], spans[:6]
    demand = int(bg.bin_sort_grouped_plain(*spans, 1 << 16, 16, 8)[6])
    for tag, cap in (("ample", min(demand, (1 << 17) - 128)),
                     ("undersized", 128 * (total // 256))):
        def call(cap=cap):
            return bg.bin_sort_grouped(*spans, cap, 16, 8)

        trace(f"b5_{tag}_{size}", call, frames, 1, out)
        print(json.dumps({"b5": tag, "slot_cap": cap, "pairs": total,
                          "event_ms": cuda_time_ms(call, 50),
                          "plain_event_ms": cuda_time_ms(
                              lambda cap=cap: bg.bin_sort_grouped_plain(
                                  *spans, cap, 16, 8), 20)}))


def p1(prims, frames, out):
    """P1's device ms a call at 128 and 256 replicas, for each primitive."""
    from cython3dmodelrenderer_tpu_torch.measure import profile_calls
    from cython3dmodelrenderer_tpu_torch.probes import epi_prims

    x, smat = epi_prims.make_input("cuda")
    for name in prims or epi_prims.ALL_PRIMS:
        dev = {r: profile_calls(lambda r=r: epi_prims.run(name, r, x, smat),
                                frames) for r in (128, 256)}
        slope, walls = epi_prims.measure(name, x, smat)
        print(json.dumps({
            "p1": name, "device_ms_ops": {str(r): d for r, d in dev.items()},
            "device_us_per_replica": (dev[256][0] - dev[128][0]) / 128 * 1e3,
            "event_us_per_replica": slope, "event_walls_ms": walls}))
    trace("p1_epi_cur6_x128", lambda: epi_prims.run("epi_cur6", 128, x, smat),
          frames, 1, out)


def sharded(model, size, frames, out):
    """World size 1 in this process (NCCL): the triangle-sharded frame
    (``render_triangle_sharded``, the merge's collectives included) beside
    the unsharded G-buffer frame it merges (``_render_view_kernel``)."""
    import tempfile

    import torch.distributed as dist

    from cython3dmodelrenderer_tpu_torch.parallel import multiview
    from cython3dmodelrenderer_tpu_torch.parallel.mesh import make_mesh

    config = pt.RenderConfig(height=size, width=size, fov=45)
    tv, tn = model.vertices_by_triangles, model.normals_by_triangles
    tc = chip_smoke.seeded_colors(model)
    light = multiview._norm_light((0.0, 0.0, 1.0))
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/pg",
                                rank=0, world_size=1)
        try:
            mesh = make_mesh([("tris", 1)])
            trace(f"unsharded_frame_{size}", lambda: multiview._render_view_kernel(
                tv, tn, tc, config, light, "cuda"), frames, 1, out)
            trace(f"triangle_sharded_world1_{size}",
                  lambda: multiview.render_triangle_sharded(
                      tv, tn, tc, config, mesh, backend="cuda"),
                  frames, 1, out)
        finally:
            dist.destroy_process_group()


def frontend_ab(sources, rounds):
    """F1's device ms, device operations and event ms a call, for the
    repository's kernel and each variant source."""
    from cython3dmodelrenderer_tpu_torch.measure import (cuda_time_ms,
                                                         profile_calls)
    from cython3dmodelrenderer_tpu_torch.ops import frontend

    libs = [("repo", None)] + [(src, build_variant(src, frontend.bind))
                               for src in sources]
    light = pt.GuroIllumination([0, 0, 1]).light_direction
    cases = []
    for name in ("sphere16k", "torus262k"):
        model = scene_model(name)
        arrays = (model.vertices_by_triangles, model.normals_by_triangles,
                  chip_smoke.seeded_colors(model))
        cases += [(f"{name}@1024 C={c}", chip_smoke.frontend_call(
            *arrays, 1024, 1024, c, False, light)) for c in (6, 3)]
    centred, colors = turntable_inputs()
    cases.append(("sweep batch x4 C=6", chip_smoke.frontend_call(
        centred.vertices_by_triangles, centred.normals_by_triangles, colors,
        1024, 1024, 6, False, light, chip_smoke.sweep_poses(4))))

    @contextlib.contextmanager
    def using(lib):
        """The wrapper on ``lib``, its plan on the variant's block."""
        if lib is None:
            yield
            return
        saved = frontend._lib, frontend.THREADS
        out = (ctypes.c_int * 4)()
        lib.frontend_constants(6, out)
        frontend._lib, frontend.THREADS = (lambda: lib), out[0]
        try:
            yield
        finally:
            frontend._lib, frontend.THREADS = saved

    for tag, (args, kw) in cases:
        def call(args=args, kw=kw):
            return frontend.frame_planes(*args, **kw)

        want = frontend.frame_planes_plain(*args, **kw)
        result = {"frontend": tag, "bound": chip_smoke.frontend_bound(
            args, kw, want)}
        for name, lib in libs:
            with using(lib):
                result[name] = {"bit_equal_to_plain": all(
                    chip_smoke.same_bits(a, b) for a, b in zip(call(), want)),
                    "event_ms": cuda_time_ms(call, 100),
                    "device_ms_ops": []}
        for r in range(rounds):
            for name, lib in (libs if r % 2 == 0 else libs[::-1]):
                with using(lib):
                    result[name]["device_ms_ops"].append(profile_calls(call, 20))
        print(json.dumps(result))


def quartiles(values):
    """Median and quartiles (``statistics.quantiles``, n=4) of ``values``."""
    q = statistics.quantiles(values, n=4)
    return {"median": q[1], "q1": q[0], "q3": q[2]}


def span_cost(cell_name, seed, frames, pairs, device="cuda:0"):
    """What the spans cost a traced frame of a benchmark cell (docstring)."""
    sys.path.insert(0, os.path.join(ROOT, "benchmark"))
    import harness
    import tracing

    from cython3dmodelrenderer_tpu_torch.utils import timing

    device = torch.device(device)
    cell = harness.Cell(cell_name, harness.catalog())
    driver = harness.load_module(cell.driver_path).Driver(
        cell.config, cell.traffic, seed, device)
    driver.build_program()
    driver.warm()
    harness.synchronizer(device)()
    loop = harness.Loop(driver, device, seed)
    span = timing.span

    def block(shut=False):
        """µs a frame of ``frames`` steps (``shut``: no span entered)."""
        timing.span = (lambda name: timing._NO_SPAN) if shut else span
        try:
            t0 = time.perf_counter()
            for _ in range(frames):
                loop.step()
            return (time.perf_counter() - t0) / frames * 1e6
        finally:
            timing.span = span

    def one_span():
        with timing.span("cost"):
            pass

    def per_call(fn, n=20000):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e6

    micro = {"span_off_us": per_call(one_span)}
    off = [block() for _ in range(pairs)]
    on, shut = [], []
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with tracing.stage_ranges(tracing.stage_targets()), profile(
            activities=activities) as prof:
        for _ in range(harness.PROFILER_WARM_STEPS):
            loop.step()
        for i in range(pairs):
            for gate in ((False, True) if i % 2 == 0 else (True, False)):
                (shut if gate else on).append(block(gate))
        micro["span_on_us"] = per_call(one_span)
    host = [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if str(e.device_type).endswith("CPU")]
    outer = [(a, b) for n, a, b in host if n == "stage:frame"]
    lead, tail = [], []
    for n, a, b in host:
        around = [(lo, hi) for lo, hi in outer if lo <= a <= hi]
        if n == timing.SPAN_PREFIX + "render" and around:
            lead.append(a - around[0][0])
            tail.append(around[0][1] - b)
    diff = [a - b for a, b in zip(on, shut)]
    print(json.dumps({
        "workload": cell_name, "frames_a_block": frames, "pairs": pairs,
        "us_per_frame": {"off": off, "spans": on, "gate_shut": shut},
        "quartiles": {"off": quartiles(off), "spans": quartiles(on),
                      "gate_shut": quartiles(shut),
                      "spans_less_gate_shut": quartiles(diff)},
        "pairs_spans_slower": sum(d > 0 for d in diff),
        "frame_range_to_render_span_us": {
            "lead": quartiles(lead) | {"max": max(lead)},
            "tail": quartiles(tail) | {"max": max(tail)}, "n": len(lead)},
        "micro": micro}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", choices=("sphere16k", "torus262k"),
                    default="sphere16k")
    ap.add_argument("--textured", action="store_true")
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "profile"))
    ap.add_argument("--backend", choices=("auto", "ratio"), default="auto")
    ap.add_argument("--sweep", default="",
                    help="comma-separated view_batch values to trace")
    ap.add_argument("--b5", action="store_true")
    ap.add_argument("--binning", action="store_true")
    ap.add_argument("--raster", nargs="*", metavar="SOURCE.cu")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--p1", nargs="*", metavar="PRIM")
    ap.add_argument("--sharded", action="store_true")
    ap.add_argument("--frontend", nargs="*", metavar="SOURCE.cu")
    ap.add_argument("--span-cost", metavar="CELL")
    ap.add_argument("--seed", type=int, default=2 ** 31 + 16)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    os.makedirs(args.out, exist_ok=True)
    if args.span_cost:
        print(smi("name,power.limit"))
        torch.set_num_threads(1)
        span_cost(args.span_cost, args.seed, args.frames, args.rounds)
        return
    if args.p1 is not None:
        print(smi("name,power.limit"))
        p1(args.p1, args.frames, args.out)
        return
    if args.raster is not None:
        print(smi("name,power.limit"))
        raster_ab(args.raster, args.rounds)
        return
    if args.frontend is not None:
        print(smi("name,power.limit"))
        frontend_ab(args.frontend, args.rounds)
        return
    model = scene_model(args.scene)
    if args.textured:
        model = chip_smoke.textured(model)
    print(smi("name,power.limit"))
    tag = (f"{args.scene}@{args.size}" + ("/textured" if args.textured
                                          else "")
           + ("/ratio" if args.backend == "ratio" else ""))
    if args.binning:
        from cython3dmodelrenderer_tpu_torch.ops import binsort

        spans = chip_smoke.frame_setup(model, "lambert_u8", args.size)[1]
        trace(f"bin_sort_{tag}", lambda: binsort.bin_sort(*spans),
              args.frames, 1, args.out)
        tx0, ntx, nty = spans[0], spans[4], spans[5]
        if (tx0.shape[0] - 1).bit_length() + (ntx * nty - 1).bit_length() <= 31:
            trace(f"bin_pairs_{tag}", lambda: binsort.bin_pairs(*spans),
                  args.frames, 1, args.out)
        return
    if args.b5:
        b5(model, args.size, args.frames, args.out)
        return
    if args.sharded:
        sharded(model, args.size, args.frames, args.out)
        return
    for name, illum in (("guro", pt.GuroIllumination([0, 0, 1])),
                        ("none", pt.NoIllumination())):
        renderer = pt.Renderer(
            pt.AdvancedPixelBufferFiller(args.size, args.size, fov=45,
                                         device="cuda", backend=args.backend),
            illum, pt.SimpleIterator, args.size, args.size)
        if not args.sweep:
            trace(f"frame_{tag}/{name}", lambda: renderer.render(model),
                  args.frames, 1, args.out, stages=True)
            continue
        centred = chip_smoke.turntable_model("cuda")
        for vb in (int(x) for x in args.sweep.split(",")):
            sweep = chip_smoke.sweep_args(renderer, centred, vb)
            trace(f"sweep_{tag}/{name}/vb{vb}",
                  lambda: renderer.render_sequence(**sweep), args.frames,
                  chip_smoke.SWEEP_VIEWS, args.out, stages=True)


if __name__ == "__main__":
    main()
