#!/usr/bin/env python3
"""GPU smoke test of cython3dmodelrenderer_tpu_torch (PyTorch + CUDA port).

Run from the repository root on a machine with an NVIDIA GPU:

    python3 chip_smoke.py

Phases (one line each; any failure exits nonzero):

1. device  — torch/CUDA versions and the card's name and power limit;
             fails when CUDA is unavailable (no CPU fallback);
2. build   — builds kernels B1 (csrc/raster.cu) and B2 (csrc/sort.cu)
             from the repository's sources with nvcc;
3. kernels — each kernel against its plain PyTorch version on the card:
             B2 on random unique keys (exact), B1 on the binned 1024²
             scenes for posts none/u8/lambert_u8 (bit-equal);
4. main    — Renderer.render at 1024², fov 45, with GuroIllumination and
             NoIllumination, on (a) assets/igor_sphere.obj, (b) a
             16,128-triangle displaced UV sphere built in memory and
             (c) $CRENDER_OBJECTS/T-Rex.obj when that file exists; checks
             the images against the plain path, determinism, the lazy
             z-buffer and that both kernels launched;
5. timing  — median steady-state ms/frame of 60 warm frames per scene
             (CUDA events), and each kernel against its plain version.

The next-to-last lines are the nvidia-smi name/power-limit line and one
JSON object with the kernels' launch counts, errors and times; the last
line is ``{"ok": true, "device": {...}}``.
"""
import json
import os
import statistics
import subprocess
import sys
import time

SIZE = 1024
FOV = 45
WARM_FRAMES = 60
# Mismatch bounds used only if a kernel is not bit-equal to its plain
# version (tests_tpu/test_tpu_parity.py:49-54, T-Rex row): fraction of
# pixels whose z differs by > 1e-3 / whose colour differs by > 0.5.
Z_FRAC_MAX, COLOR_FRAC_MAX = 5e-5, 1.5e-4
TRI_SPHERE_SEGMENTS, TRI_SPHERE_RINGS = 128, 64


class SmokeFailure(Exception):
    pass


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# scenes
# ---------------------------------------------------------------------------

def displaced_sphere(segments, rings):
    """Vertices and triangles of a displaced UV sphere, built like
    tools/make_igor_sphere.py (same radius formula, quads fan-split)."""
    import numpy as np

    verts, index = [], {}
    for r in range(rings + 1):
        phi = np.pi * r / rings
        for s in range(segments):
            if r in (0, rings) and s > 0:
                continue
            theta = 2.0 * np.pi * s / segments
            rad = 1.0 + 0.08 * np.sin(6.0 * theta) * np.sin(5.0 * phi)
            index[(r, s)] = len(verts)
            verts.append((rad * np.sin(phi) * np.cos(theta), rad * np.cos(phi),
                          rad * np.sin(phi) * np.sin(theta)))

    def vid(r, s):
        return index[(r, 0 if r in (0, rings) else s % segments)]

    faces = []
    for r in range(rings):
        for s in range(segments):
            a, b = vid(r, s), vid(r, s + 1)
            c, d = vid(r + 1, s + 1), vid(r + 1, s)
            if r == 0:
                faces.append((a, c, d))
            elif r == rings - 1:
                faces.append((a, b, d))
            else:
                faces += [(a, b, c), (a, c, d)]
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)


def posed(model, push_back):
    """The bench.py pose: README rotation, fit, and for the unit-radius
    spheres one more unit of depth (bench.py:28-47)."""
    from cython3dmodelrenderer_tpu_torch import fit_model

    model.rotate([-90, 180, 0])
    model.rotate([10, -80, 0])
    fit_model(model)
    if push_back:
        model.shift([0.0, 0.0, 1.0])
    return model


def load_scenes(device):
    from cython3dmodelrenderer_tpu_torch import Model

    root = os.path.dirname(os.path.abspath(__file__))
    scenes = [("igor_sphere", lambda: posed(Model.read_model(
        os.path.join(root, "assets", "igor_sphere.obj"), device=device), True))]

    def sphere():
        v, f = displaced_sphere(TRI_SPHERE_SEGMENTS, TRI_SPHERE_RINGS)
        return posed(Model(v, f, device=device), True)

    scenes.append(("sphere16k", sphere))
    trex = os.path.join(os.environ.get("CRENDER_OBJECTS", ""), "T-Rex.obj")
    if os.environ.get("CRENDER_OBJECTS") and os.path.exists(trex):
        scenes.append(("trex", lambda: posed(Model.read_model(trex,
                                                             device=device),
                                             False)))
    return {name: make() for name, make in scenes}


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is False — this smoke "
                           "test needs a CUDA GPU and does not fall back")
    smi = smi_line()
    say("device", f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} | {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()} | nvidia-smi: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build():
    from cython3dmodelrenderer_tpu_torch import cuda_build

    for name in ("sort", "raster"):
        t0 = time.perf_counter()
        path = cuda_build.build(name)
        cuda_build.load(name)
        log = path.with_suffix(".log")
        usage = [ln.split("ptxas info    :")[-1].strip()
                 for ln in (log.read_text().splitlines() if log.exists() else [])
                 if "Used" in ln or "spill" in ln]
        say("build", f"{name}: {time.perf_counter() - t0:.1f} s -> "
            f"{path.name}; ptxas: {' / '.join(usage) or 'cached'}")


def frame_inputs(model, post):
    """The binned raster inputs a 1024² main-path frame of ``model`` gives
    kernel B1 (and its pair keys, B2's input), built with the port's own
    glue; an untextured model gets seeded random flat colours."""
    import torch

    from cython3dmodelrenderer_tpu_torch.config import RenderConfig
    from cython3dmodelrenderer_tpu_torch.ops import binning, binsort, raster
    from cython3dmodelrenderer_tpu_torch.ops.projection import (
        project_to_screen, visibility_masks)
    from cython3dmodelrenderer_tpu_torch.ops.sort import sort_i32_plain

    config = RenderConfig(height=SIZE, width=SIZE, fov=FOV)
    tv, tn = model.vertices_by_triangles, model.normals_by_triangles
    tc = model.colors_by_triangles
    if tc is None:
        per_tri = torch.randint(256, (model.n_triangles(), 1, 3),
                                generator=torch.Generator().manual_seed(3))
        tc = per_tri.expand(-1, 3, 3).to(device=tv.device, dtype=torch.float32)
    deg, back = visibility_masks(tv, tn)
    ts = project_to_screen(tv, config)
    n_attrs = 3 if post == "u8" else 6
    rows, tx0, cx, ty0, cy, counts = binning.plane_data(
        ts, ~deg & ~back, config, raster.TILE_H, raster.TILE_W, colors=tc,
        normals=None if n_attrs == 3 else tn)
    ntx, nty = SIZE // raster.TILE_W, SIZE // raster.TILE_H
    total = int(counts.sum())
    tri_bits = binsort.key_bits(tv.shape[0], ntx * nty)
    tri_p, tile_p = binsort.expand_pairs(tx0, cx, ty0, cy, ntx, total)
    keys = (tile_p << tri_bits) | tri_p
    pair_tri, starts, tcounts = binsort.bin_pairs(tx0, cx, ty0, cy, ntx, nty,
                                                  total, sort=sort_i32_plain)
    return dict(rows=rows, pair_tri=pair_tri, tile_starts=starts,
                tile_counts=tcounts, ntx=ntx, nty=nty, height=SIZE, width=SIZE,
                n_attrs=n_attrs, z_init=config.z_init), keys


def compare_gbuffers(got, want):
    """(bit_equal, max_abs_err, z_frac, color_frac) of two G-buffer triples."""
    import torch

    eq = all(torch.equal(a, b) for a, b in zip(got, want))
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    zf = float(((got[1] - want[1]).abs() > 1e-3).float().mean())
    cf = float(((got[0] - want[0]).abs().amax(-1) > 0.5).float().mean())
    return eq, err, zf, cf


def phase_kernels(scenes, light):
    import torch

    from cython3dmodelrenderer_tpu_torch.ops.raster import (raster_tiles,
                                                            raster_tiles_plain)
    from cython3dmodelrenderer_tpu_torch.ops.sort import sort_i32, sort_i32_plain

    gen = torch.Generator(device="cuda").manual_seed(0)
    sort_err = 0
    for n in (1, 1000, 24576, 1 << 15, (1 << 18) + 17):
        # unique non-negative keys spread over [0, 2^29)
        perm = torch.randperm(4 * n, generator=gen, device="cuda")[:n]
        keys = (perm * 511 + 3).to(torch.int32)
        got, want = sort_i32(keys), sort_i32_plain(keys)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"B2 sort disagrees at n={n}")
        sort_err = max(sort_err, int((got - want).abs().max()))
    say("kernels", "B2 sort == torch.sort at n = 1, 1000, 24576, 32768, 262161")

    raster_err = 0.0
    inputs = {}
    for name, model in scenes.items():
        for post in ("none", "u8", "lambert_u8"):
            kw, keys = frame_inputs(model, post)
            inputs.setdefault(name, {})[post] = (kw, keys)
            lt = light if post == "lambert_u8" else None
            g_k, i_k = raster_tiles(**kw, light=lt, gbuffer=post == "none",
                                    image=post != "none")
            g_p, i_p = raster_tiles_plain(**kw, light=lt,
                                          gbuffer=post == "none",
                                          image=post != "none")
            torch.cuda.synchronize()
            if post == "none":
                eq, err, zf, cf = compare_gbuffers(g_k, g_p)
                raster_err = max(raster_err, err)
                require(eq or (zf <= Z_FRAC_MAX and cf <= COLOR_FRAC_MAX),
                        f"B1 {name}/none: z frac {zf}, colour frac {cf}")
                detail = "bit-equal" if eq else f"z frac {zf} colour frac {cf}"
            else:
                diff = (i_k.int() - i_p.int()).abs()
                frac = float((diff.amax(-1) > 0).float().mean())
                raster_err = max(raster_err, float(diff.max()))
                require(frac <= COLOR_FRAC_MAX,
                        f"B1 {name}/{post}: image mismatch fraction {frac}")
                detail = "bit-equal" if frac == 0 else f"mismatch frac {frac}"
            say("kernels", f"B1 raster {name} {post}: {detail} "
                f"({int(kw['pair_tri'].numel())} pairs)")
    return sort_err, raster_err, inputs


def seeded_render(renderer, model):
    """Render with the fallback colours of a fixed seed (an untextured
    model draws new random colours on every render otherwise)."""
    renderer.generator.manual_seed(7)
    return renderer.render(model).array.clone()


def make_renderer(illum, backend="auto"):
    import torch

    from cython3dmodelrenderer_tpu_torch import (AdvancedPixelBufferFiller,
                                                 Renderer, SimpleIterator)

    filler = AdvancedPixelBufferFiller(SIZE, SIZE, fov=FOV, device="cuda",
                                       backend=backend)
    return Renderer(filler, illum, SimpleIterator, SIZE, SIZE,
                    generator=torch.Generator())


def phase_main(scenes):
    import torch

    from cython3dmodelrenderer_tpu_torch import GuroIllumination, NoIllumination
    from cython3dmodelrenderer_tpu_torch.ops.raster import raster_tiles
    from cython3dmodelrenderer_tpu_torch.ops.sort import sort_i32

    illums = (("guro", GuroIllumination([0, 0, 1])), ("none", NoIllumination()))
    raster_tiles.launches = 0
    sort_i32.launches = 0
    results = {}
    for name, model in scenes.items():
        for iname, illum in illums:
            renderer = make_renderer(illum)
            img1 = seeded_render(renderer, model)
            img2 = seeded_render(renderer, model)
            results[(name, iname)] = (renderer, img1, img2,
                                      renderer.z_buffer.array)
    torch.cuda.synchronize()
    launches = {"raster": raster_tiles.launches, "sort": sort_i32.launches}

    for (name, iname), (renderer, img1, img2, z) in results.items():
        require(img1.shape == (SIZE, SIZE, 3) and img1.dtype == torch.uint8,
                f"{name}/{iname}: image {tuple(img1.shape)} {img1.dtype}")
        lit = float((img1.amax(-1) > 0).float().mean())
        require(lit > 0.05, f"{name}/{iname}: image is empty ({lit})")
        require(torch.equal(img1, img2), f"{name}/{iname}: renders differ")
        bg = (z == 1e6)[..., 0]
        fg = z[..., 0][~bg]
        require(bool(bg.any()) and bool(torch.isfinite(fg).all())
                and float(fg.max()) <= 1.0 and float(fg.min()) >= 0.0,
                f"{name}/{iname}: z_buffer does not read 1e6 off the model")
        require(bool((img1[bg] == 0).all()),
                f"{name}/{iname}: background pixels are not black")
        # the same frame through the plain versions, on the card
        ref = seeded_render(make_renderer(renderer.illumination, "torch"),
                            scenes[name])
        require(torch.equal(img1, ref),
                f"{name}/{iname}: kernel frame != plain-version frame "
                f"({float((img1 != ref).any(-1).float().mean())} of pixels)")
        say("main", f"{name} {iname}: {lit:.4f} of pixels lit, deterministic, "
            f"== plain path, z background 1e6, "
            f"{renderer.pixel_buffer_filler.last_pairs} pairs")
    require(launches["raster"] > 0 and launches["sort"] > 0,
            f"a kernel was not launched on the main path: {launches}")
    say("main", f"kernel launches on the main path: {launches}")
    return launches, results


def time_cuda(fn, n):
    """Median ms of ``n`` calls of ``fn`` after warm-up, with CUDA events."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_timing(scenes, results, inputs, light):
    import torch

    from cython3dmodelrenderer_tpu_torch.ops.raster import (raster_tiles,
                                                            raster_tiles_plain)
    from cython3dmodelrenderer_tpu_torch.ops.sort import sort_i32, sort_i32_plain

    frame_ms = {}
    for (name, iname), (renderer, *_rest) in results.items():
        model = scenes[name]
        ms = time_cuda(lambda: renderer.render(model), WARM_FRAMES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(WARM_FRAMES):
            renderer.render(model)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / WARM_FRAMES * 1e3
        frame_ms[f"{name}/{iname}"] = {"median_event_ms": ms, "mean_wall_ms": wall}
        say("timing", f"{name} {iname}: {ms:.4f} ms/frame median (CUDA events, "
            f"{WARM_FRAMES} warm frames), {wall:.4f} ms/frame mean wall, "
            f"{model.n_triangles()} triangles")
    # the kernels at the main path's shapes: the 16k-triangle sphere's frame
    kw, keys = inputs["sphere16k"]["lambert_u8"]
    kt = {
        "sort": (time_cuda(lambda: sort_i32(keys), 100),
                 time_cuda(lambda: sort_i32_plain(keys), 100)),
        "raster": (time_cuda(lambda: raster_tiles(**kw, light=light,
                                                  gbuffer=False, image=True),
                             100),
                   time_cuda(lambda: raster_tiles_plain(**kw, light=light,
                                                        gbuffer=False,
                                                        image=True), 20)),
    }
    for k, (ms, plain) in kt.items():
        say("timing", f"{k}: kernel {ms:.4f} ms, plain {plain:.4f} ms "
            f"(sphere16k lambert_u8 frame: {keys.numel()} pair keys)")
    return frame_ms, kt


def main():
    try:
        import torch
    except ImportError as e:
        print(f"[device] FAIL: {e}", flush=True)
        return 1
    try:
        smi = phase_device()
        from cython3dmodelrenderer_tpu_torch import GuroIllumination
    except (SmokeFailure, ImportError, OSError,
            subprocess.SubprocessError) as e:
        print(f"[device] FAIL: {e}", flush=True)
        return 1
    try:
        phase_build()
        scenes = load_scenes("cuda")
        say("scenes", ", ".join(f"{n}: {m.n_triangles()} triangles"
                                for n, m in scenes.items()))
        light = GuroIllumination([0, 0, 1]).light_direction
        sort_err, raster_err, inputs = phase_kernels(scenes, light)
        launches, results = phase_main(scenes)
        frame_ms, kt = phase_timing(scenes, results, inputs, light)
    except SmokeFailure as e:
        print(f"FAIL: {e}", flush=True)
        return 1
    kernels = [
        {"name": "raster_tiles (B1)", "route": "cuda",
         "source": "cython3dmodelrenderer_tpu_torch/csrc/raster.cu",
         "replaces": "cython3dmodelrenderer_tpu/ops/raster_pallas.py:293",
         "launches": launches["raster"], "max_abs_err": raster_err,
         "ms": kt["raster"][0], "plain_ms": kt["raster"][1]},
        {"name": "sort_i32 (B2)", "route": "cuda",
         "source": "cython3dmodelrenderer_tpu_torch/csrc/sort.cu",
         "replaces": "cython3dmodelrenderer_tpu/ops/sort_pallas.py:32",
         "launches": launches["sort"], "max_abs_err": sort_err,
         "ms": kt["sort"][0], "plain_ms": kt["sort"][1]},
    ]
    print(json.dumps({"frame_ms": frame_ms}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
