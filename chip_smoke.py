#!/usr/bin/env python3
"""GPU smoke test of cython3dmodelrenderer_tpu_torch (PyTorch + CUDA port).

Run from the repository root on a machine with an NVIDIA GPU:

    python3 chip_smoke.py

Phases (one line each; any failure exits nonzero):

1. device  — torch/CUDA versions and the card's name and power limit;
             fails when CUDA is unavailable (no CPU fallback);
2. build   — builds kernels B1 (csrc/raster.cu), B2 (csrc/sort.cu), B4
             (csrc/binsort.cu), B5 (csrc/binsort_grouped.cu), P2
             (csrc/vpu_cal.cu) and P1 (csrc/epi_prims.cu) from the
             repository's sources, one nvcc each, all started together;
3. kernels — each kernel against its plain PyTorch version on the card:
             B2 on random unique keys (exact), B1 on the binned 1024²
             scenes for posts none/u8/lambert_u8 (bit-equal);
4. main    — Renderer.render at 1024², fov 45, with GuroIllumination and
             NoIllumination, on (a) assets/igor_sphere.obj, (b) a
             16,128-triangle displaced UV sphere built in memory and
             (c) $CRENDER_OBJECTS/T-Rex.obj when that file exists; checks
             the images against the plain path, determinism, the lazy
             z-buffer and that both kernels launched (the sort route);
             one Renderer, filler and model built with no device
             argument must render on the card (the default device);
5. timing  — median steady-state ms/frame of 60 warm frames per scene
             (CUDA events), and each kernel against its plain version;
6. large   — the un-grouped (counting-sort) path: B4 against its plain
             version (bit-equal, and equal to itself on a second run) on
             the spans of sphere16k@2048², torus262k@1024² and @4096² (a
             262,144-triangle displaced torus built in memory) and on 0
             and 1 pairs; B1 on B4's bins (the B3 route) against the plain
             raster; Renderer.render on those three frames with both
             illuminations, checked as in phase 4, B4 and B1 launched and
             B2 not; rasterize() once; then their ms/frame (20 warm
             frames), B4 and the B3 route against their plain versions at
             torus262k@1024², and both routes' binning at sphere16k@1024²;
7. sweep   — the multi-view path: an 8-view turntable of sphere16k at
             1024² through Renderer.render_sequence with GuroIllumination
             and NoIllumination at view_batch 1, 2, 4 and 8 (1, 2 and 4 on
             the sort route, 8 on the counting route: 16,384 stacked
             tiles), fast shade at 1 and 4; every view equal to its
             view_batch=1 render and to render_frame on the same posed
             arrays, B1 launched N/V times a sweep, one view_batch=8
             sweep equal to the plain path; B1's view-batched launch
             against its plain version at view_batch 2 (bit-equal); then
             ms per view per view_batch (CUDA events over the sweep / N);
8. b5      — B5 (csrc/binsort_grouped.cu, on no render path) against its
             plain version on sphere16k@1024²'s spans, group 16, sub 8, at
             an ample and an undersized slot_cap: bit-equal in every
             output, equal to itself on a second run; its time and the
             plain version's;
9. probes  — the calibration probes' path, as their ``__main__``s run it:
             P2 (probes/vpu_cal.py) at n_ops 8/32/128/512 and P1
             (probes/epi_prims.py), all 15 primitives at 0/128/256
             replicas, printed as the scripts print them; then P2 against
             its plain version at n_ops 8, 32 and 512 (bit-equal, equal to
             itself on a second run) and P1 at 0, 2 and 128 replicas: one
             replica bit-equal to the plain version for the element
             primitives and within rtol 2e-6 for the summed ones (up to
             2 x 65,536 floats summed in another order); at R replicas
             the kernel and the plain version each equal bit for bit to
             R f32 adds of their own one-replica value, and the kernel
             equal to the plain version (element primitives) or within
             rtol 2e-6 + R x 2^-23 (the rest); equal to itself on a second
             run; torch.matmul beside segsum / segsum6 as a yardstick.

The next-to-last lines are the nvidia-smi name/power-limit line and one
JSON object with the kernels' launch counts, errors, times and bounds
(``bound_ms``: the larger of the bytes moved over 3.35 TB/s and the f32
operations this run's inputs need over 33.5 T instructions/s; P1's
``max_abs_err`` is the one-replica difference that its checks hold); the
last line is ``{"ok": true, "device": {...}}``.
"""
import json
import os
import subprocess
import sys
import time

SIZE = 1024
FOV = 45
DEVICE = "cuda"
WARM_FRAMES = 60
# Mismatch bounds used only if a kernel is not bit-equal to its plain
# version (tests_tpu/test_tpu_parity.py:49-54, T-Rex row): fraction of
# pixels whose z differs by > 1e-3 / whose colour differs by > 0.5.
Z_FRAC_MAX, COLOR_FRAC_MAX = 5e-5, 1.5e-4
TRI_SPHERE_SEGMENTS, TRI_SPHERE_RINGS = 128, 64
TORUS_QUADS = (512, 256)           # 262,144 triangles
KERNEL_SOURCES = ("sort", "raster", "binsort", "binsort_grouped", "vpu_cal",
                  "epi_prims")
# the un-grouped (counting-sort) path: frames past grouped_limits_ok
LARGE_FRAMES = (("sphere16k", 2048), ("torus262k", 1024), ("torus262k", 4096))
LARGE_WARM_FRAMES = 20
# the multi-view sweep: N views of the centred sphere16k, one unit deeper
# than fit_model puts it (the bench.py pose of the unit spheres)
SWEEP_VIEWS = 8
SWEEP_BATCHES = (1, 2, 4, 8)
FAST_BATCHES = (1, 4)
SWEEP_SHIFT = (0.0, 0.0, 2.0)
SWEEP_REPS = 10
B5_GROUP, B5_SUB = 16, 8
P2_CHECK_N_OPS = (8, 32, 512)
P2_TIMED = 512                     # n_ops of the kernels line's P2 entry
P1_CHECK_REPS = (0, 2, 128)
P1_RTOL = 2e-6           # summed primitives: up to 2 x 65,536 floats
# R replicas: each of R f32 adds rounds by at most half an ulp of the
# running sum, R x 2^-24 relative on each side
P1_FOLD_ULP = 2.0 ** -23
P1_TIMED = ("epi_cur6", 128)


class SmokeFailure(Exception):
    pass


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


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


def displaced_torus(nu, nv):
    """Vertices and triangles of a displaced torus: an (nu x nv)-quad grid
    wrapping both ways, R = 1, tube radius 0.45 (1 + 0.08 sin 6θ sin 5φ),
    each quad split into (a, b, c) and (a, c, d). Every vertex has degree 6
    (a UV sphere this dense has a degree-nu pole)."""
    import numpy as np

    theta = 2.0 * np.pi * np.arange(nu) / nu           # around the main axis
    phi = 2.0 * np.pi * np.arange(nv) / nv             # around the tube
    th, ph = np.meshgrid(theta, phi, indexing="ij")
    r = 0.45 * (1.0 + 0.08 * np.sin(6.0 * th) * np.sin(5.0 * ph))
    ring = 1.0 + r * np.cos(ph)
    verts = np.stack([ring * np.cos(th), r * np.sin(ph), ring * np.sin(th)],
                     axis=-1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij")

    def vid(a, b):
        return (a % nu) * nv + b % nv

    a, b, c, d = vid(i, j), vid(i + 1, j), vid(i + 1, j + 1), vid(i, j + 1)
    faces = np.concatenate([np.stack([a, b, c], -1).reshape(-1, 3),
                            np.stack([a, c, d], -1).reshape(-1, 3)])
    return verts.astype(np.float32), faces.astype(np.int32)


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


def load_large_scenes(device, scenes):
    """The un-grouped path's scenes: sphere16k (2048²) and torus262k."""
    from cython3dmodelrenderer_tpu_torch import Model

    t0 = time.perf_counter()
    v, f = displaced_torus(*TORUS_QUADS)
    torus = posed(Model(v, f, device=device), True)
    say("scenes", f"torus262k: {torus.n_triangles()} triangles, built in "
        f"{time.perf_counter() - t0:.1f} s")
    return {"sphere16k": scenes["sphere16k"], "torus262k": torus}


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is False — this smoke "
                           "test needs a CUDA GPU and does not fall back")
    from cython3dmodelrenderer_tpu_torch.measure import smi as query_smi

    smi = query_smi("name,power.limit")
    say("device", f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} | {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()} | nvidia-smi: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build():
    """Build every kernel with one nvcc each, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from cython3dmodelrenderer_tpu_torch import cuda_build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        paths = list(pool.map(cuda_build.build, KERNEL_SOURCES))
    wall = time.perf_counter() - t0
    for name, path in zip(KERNEL_SOURCES, paths):
        cuda_build.load(name)
        log = path.with_suffix(".log")
        usage = [ln.split("ptxas info    :")[-1].strip()
                 for ln in (log.read_text().splitlines() if log.exists() else [])
                 if "Used" in ln or "spill" in ln]
        say("build", f"{name} -> {path.name}; ptxas: "
            f"{' / '.join(usage) or 'cached'}")
    say("build", f"{len(paths)} kernels built in parallel in {wall:.1f} s")


def seeded_colors(model):
    """The model's colours, or seeded random flat ones when untextured."""
    import torch

    tc = model.colors_by_triangles
    if tc is None:
        per_tri = torch.randint(256, (model.n_triangles(), 1, 3),
                                generator=torch.Generator().manual_seed(3))
        tc = per_tri.expand(-1, 3, 3).to(
            device=model.vertices_by_triangles.device, dtype=torch.float32)
    return tc


def frame_setup(model, post, size):
    """Plane rows and tile spans of a size² frame of ``model``, built with
    the port's own glue: ``(raster kwargs without bins, spans)`` where
    ``spans`` = (tx0, cx, ty0, cy, ntx, nty, total), bin_sort's input."""
    from cython3dmodelrenderer_tpu_torch.config import RenderConfig
    from cython3dmodelrenderer_tpu_torch.ops import binning, raster
    from cython3dmodelrenderer_tpu_torch.ops.projection import (
        project_to_screen, visibility_masks)

    config = RenderConfig(height=size, width=size, fov=FOV)
    tv, tn = model.vertices_by_triangles, model.normals_by_triangles
    deg, back = visibility_masks(tv, tn)
    ts = project_to_screen(tv, config)
    n_attrs = 3 if post == "u8" else 6
    rows, tx0, cx, ty0, cy, counts = binning.plane_data(
        ts, ~deg & ~back, config, raster.TILE_H, raster.TILE_W,
        colors=seeded_colors(model), normals=None if n_attrs == 3 else tn)
    ntx, nty = size // raster.TILE_W, size // raster.TILE_H
    kw = dict(rows=rows, ntx=ntx, nty=nty, height=size, width=size,
              n_attrs=n_attrs, z_init=config.z_init)
    return kw, (tx0, cx, ty0, cy, ntx, nty, int(counts.sum()))


def with_bins(kw, bins):
    pair_tri, starts, counts = bins
    return dict(kw, pair_tri=pair_tri, tile_starts=starts, tile_counts=counts)


# ---------------------------------------------------------------------------
# bounds: (bound_ms, bound_by) from this run's inputs
# ---------------------------------------------------------------------------

def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def raster_bound(kw):
    """B1 / B3: rows, pairs and bin tables read once, the u8 image written
    once; f32 operations the bins need (``raster.walk_instructions``: 28
    per (pair, pixel) in the pair's ceil bbox, 4 per other pixel of its
    tile; the winner's epilogue is left out, so this is a floor)."""
    from cython3dmodelrenderer_tpu_torch.measure import roofline_ms
    from cython3dmodelrenderer_tpu_torch.ops import raster

    n_views = kw.get("n_views", 1)
    moved = (nbytes(kw["rows"], kw["pair_tri"], kw["tile_starts"],
                    kw["tile_counts"])
             + n_views * kw["height"] * kw["width"] * 3)
    ops = raster.walk_instructions(kw["rows"], kw["pair_tri"],
                                   kw["tile_starts"], kw["tile_counts"],
                                   kw["ntx"], kw["nty"], kw["height"],
                                   kw["width"], n_views)
    return roofline_ms(moved, ops)


def sort_bound(keys):
    """B2: keys read and written once; n log2 n comparisons."""
    import math

    from cython3dmodelrenderer_tpu_torch.measure import roofline_ms

    n = keys.numel()
    return roofline_ms(2 * nbytes(keys), n * math.ceil(math.log2(max(n, 2))))


def binning_bound(spans, outputs, pairs):
    """B4 / B5: spans read once, every output written once; a count and a
    placement per pair."""
    from cython3dmodelrenderer_tpu_torch.measure import roofline_ms

    return roofline_ms(nbytes(*spans[:4], *outputs), 2 * pairs)


def frame_inputs(model, post):
    """The binned raster inputs a 1024² main-path frame of ``model`` gives
    kernel B1 (and its pair keys, B2's input)."""
    from cython3dmodelrenderer_tpu_torch.ops import binsort
    from cython3dmodelrenderer_tpu_torch.ops.sort import sort_i32_plain

    kw, spans = frame_setup(model, post, SIZE)
    tx0, cx, ty0, cy, ntx, nty, total = spans
    tri_bits = binsort.key_bits(tx0.shape[0], ntx * nty)
    tri_p, tile_p = binsort.expand_pairs(tx0, cx, ty0, cy, ntx, total)
    keys = (tile_p << tri_bits) | tri_p
    bins = binsort.bin_pairs(*spans, sort=sort_i32_plain)
    return with_bins(kw, bins), keys


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


def synthetic_spans(n_tris, ntx, nty, n_live):
    """Spans of ``n_tris`` triangles of which the first ``n_live`` (0 or 1)
    cover one tile each, the rest culled: 0 and 1 pairs."""
    import torch

    zeros = torch.zeros(n_tris, dtype=torch.int32, device="cuda")
    live = (torch.arange(n_tris, device="cuda") < n_live).to(torch.int32)
    return (live * (ntx // 2), live, live * (nty // 3), live, ntx, nty, n_live)


def phase_kernels_large(scenes, light):
    """B4 against its plain version at the un-grouped frames' spans, and
    B1 on B4's bins (the B3 route) against the plain raster."""
    import torch

    from cython3dmodelrenderer_tpu_torch.ops.binsort import (bin_sort,
                                                             bin_sort_plain)
    from cython3dmodelrenderer_tpu_torch.ops.raster import (raster_tiles,
                                                            raster_tiles_plain)

    cases = [(f"{name}@{size}", frame_setup(scenes[name], "lambert_u8", size)[1])
             for name, size in LARGE_FRAMES]
    cases += [(f"{n} pair", synthetic_spans(4096, 32, 64, n)) for n in (0, 1)]
    binsort_err = 0
    for tag, spans in cases:
        got, again, want = bin_sort(*spans), bin_sort(*spans), bin_sort_plain(*spans)
        torch.cuda.synchronize()
        binsort_err = max([binsort_err] + [int((a - b).abs().max())
                                           for a, b in zip(got, want) if a.numel()])
        require(all(torch.equal(a, b) for a, b in zip(got, want)),
                f"B4 {tag}: bins differ from the plain version")
        require(all(torch.equal(a, b) for a, b in zip(got, again)),
                f"B4 {tag}: two runs differ")
        say("kernels", f"B4 bin_sort {tag}: bit-equal to plain, deterministic "
            f"({spans[-1]} pairs, {spans[4] * spans[5]} tiles, max bin "
            f"{int(got[2].max())})")

    inputs = {}
    b3_err = 0.0
    for name, size in LARGE_FRAMES[:2]:
        for post in ("none", "u8", "lambert_u8"):
            kw, spans = frame_setup(scenes[name], post, size)
            kw = with_bins(kw, bin_sort(*spans))
            inputs[(name, size, post)] = kw
            opts = dict(light=light if post == "lambert_u8" else None,
                        gbuffer=post == "none", image=post != "none")
            g_k, i_k = raster_tiles(**kw, **opts)
            g_p, i_p = raster_tiles_plain(**kw, **opts)
            torch.cuda.synchronize()
            pairs = list(zip(g_k, g_p)) if post == "none" else [(i_k, i_p)]
            b3_err = max([b3_err] + [float((a.float() - b.float()).abs().max())
                                     for a, b in pairs])
            require(all(torch.equal(a, b) for a, b in pairs),
                    f"B3 route {name}@{size} {post}: B1 on B4 bins differs "
                    "from the plain raster")
            say("kernels", f"B3 route (B1 on B4 bins) {name}@{size} {post}: "
                f"bit-equal ({spans[-1]} pairs)")
    return binsort_err, b3_err, inputs


def seeded_render(renderer, model):
    """Render with the fallback colours of a fixed seed (an untextured
    model draws new random colours on every render otherwise)."""
    renderer.generator.manual_seed(7)
    return renderer.render(model).array.clone()


def make_renderer(illum, backend="auto", size=SIZE):
    import torch

    from cython3dmodelrenderer_tpu_torch import (AdvancedPixelBufferFiller,
                                                 Renderer, SimpleIterator)

    filler = AdvancedPixelBufferFiller(size, size, fov=FOV, device=DEVICE,
                                       backend=backend)
    return Renderer(filler, illum, SimpleIterator, size, size,
                    generator=torch.Generator())


def check_frame(tag, img1, img2, z, size):
    """Phase-4 checks of one rendered frame: shape, lit, deterministic,
    z_buffer 1e6 off the model and in [0, 1] on it, black background."""
    import torch

    require(img1.shape == (size, size, 3) and img1.dtype == torch.uint8,
            f"{tag}: image {tuple(img1.shape)} {img1.dtype}")
    lit = float((img1.amax(-1) > 0).float().mean())
    require(lit > 0.05, f"{tag}: image is empty ({lit})")
    require(torch.equal(img1, img2), f"{tag}: renders differ")
    bg = (z == 1e6)[..., 0]
    fg = z[..., 0][~bg]
    require(bool(bg.any()) and bool(torch.isfinite(fg).all())
            and float(fg.max()) <= 1.0 and float(fg.min()) >= 0.0,
            f"{tag}: z_buffer does not read 1e6 off the model")
    require(bool((img1[bg] == 0).all()),
            f"{tag}: background pixels are not black")
    return lit


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
    default = default_device_render()
    torch.cuda.synchronize()
    launches = {"raster": raster_tiles.launches, "sort": sort_i32.launches}

    for (name, iname), (renderer, img1, img2, z) in results.items():
        lit = check_frame(f"{name}/{iname}", img1, img2, z, SIZE)
        # the same frame through the plain versions, on the card
        ref = seeded_render(make_renderer(renderer.illumination, "torch"),
                            scenes[name])
        require(torch.equal(img1, ref),
                f"{name}/{iname}: kernel frame != plain-version frame "
                f"({float((img1 != ref).any(-1).float().mean())} of pixels)")
        say("main", f"{name} {iname}: {lit:.4f} of pixels lit, deterministic, "
            f"== plain path, z background 1e6, "
            f"{renderer.pixel_buffer_filler.last_pairs} pairs")
    renderer, img = default
    require(renderer.device.type == "cuda" and img.device.type == "cuda"
            and renderer.pixel_buffer_filler.backend == "cuda",
            f"no device argument: rendered on {img.device}")
    require(torch.equal(img, results[("igor_sphere", "guro")][1]),
            "no device argument: igor_sphere guro differs from the cuda frame")
    say("main", f"Renderer, filler and Model.read_model with no device: on "
        f"{img.device}, backend {renderer.pixel_buffer_filler.backend}, "
        "== the igor_sphere guro frame")
    require(launches["raster"] > 0 and launches["sort"] > 0,
            f"a kernel was not launched on the main path: {launches}")
    say("main", f"kernel launches on the main path: {launches}")
    return launches, results


def default_device_render():
    """igor_sphere through a Renderer, filler and model built with no
    device argument: the entry points' default is the card."""
    import torch

    from cython3dmodelrenderer_tpu_torch import (AdvancedPixelBufferFiller,
                                                 GuroIllumination, Model,
                                                 Renderer, SimpleIterator)

    root = os.path.dirname(os.path.abspath(__file__))
    model = posed(Model.read_model(os.path.join(root, "assets",
                                                "igor_sphere.obj")), True)
    renderer = Renderer(AdvancedPixelBufferFiller(SIZE, SIZE, fov=FOV),
                        GuroIllumination([0, 0, 1]), SimpleIterator, SIZE,
                        SIZE, generator=torch.Generator())
    return renderer, seeded_render(renderer, model)


def phase_large(scenes):
    """The un-grouped path through ``Renderer.render``: frames past
    ``grouped_limits_ok`` take the counting-sort route (B4, then B1) and
    never B2; ``rasterize()`` once."""
    import torch

    from cython3dmodelrenderer_tpu_torch import GuroIllumination, NoIllumination
    from cython3dmodelrenderer_tpu_torch.config import RenderConfig
    from cython3dmodelrenderer_tpu_torch.ops.binsort import bin_sort
    from cython3dmodelrenderer_tpu_torch.ops.projection import (
        project_to_screen, visibility_masks)
    from cython3dmodelrenderer_tpu_torch.ops.raster import (rasterize,
                                                            raster_tiles,
                                                            render_frame)
    from cython3dmodelrenderer_tpu_torch.ops.sort import sort_i32

    illums = (("guro", GuroIllumination([0, 0, 1])), ("none", NoIllumination()))
    model = scenes["torus262k"]
    config = RenderConfig(height=SIZE, width=SIZE, fov=FOV)
    tv, tn = model.vertices_by_triangles, model.normals_by_triangles
    tc = seeded_colors(model)
    deg, back = visibility_masks(tv, tn)
    screen = project_to_screen(tv, config)
    bin_sort.launches = raster_tiles.launches = sort_i32.launches = 0
    results = {}
    for name, size in LARGE_FRAMES:
        for iname, illum in illums:
            renderer = make_renderer(illum, size=size)
            img1 = seeded_render(renderer, scenes[name])
            img2 = seeded_render(renderer, scenes[name])
            results[(name, size, iname)] = (renderer, img1, img2,
                                            renderer.z_buffer.array)
    gbuf = rasterize(screen, tc, tn, ~deg & ~back, config)
    torch.cuda.synchronize()
    launches = {"binsort": bin_sort.launches, "raster": raster_tiles.launches,
                "sort": sort_i32.launches}

    for (name, size, iname), (renderer, img1, img2, z) in results.items():
        tag = f"{name}@{size}/{iname}"
        lit = check_frame(tag, img1, img2, z, size)
        t0 = time.perf_counter()
        ref = seeded_render(make_renderer(renderer.illumination, "torch", size),
                            scenes[name])
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        require(torch.equal(img1, ref),
                f"{tag}: kernel frame != plain-version frame "
                f"({float((img1 != ref).any(-1).float().mean())} of pixels)")
        say("large", f"{tag}: {lit:.4f} of pixels lit, deterministic, == plain "
            f"path ({plain_s:.2f} s for the plain frame), z background 1e6, "
            f"{renderer.pixel_buffer_filler.last_pairs} pairs")
    ref = render_frame(tv, tn, tc, config, post="none", backend="torch")[0]
    require(all(torch.equal(a, b) for a, b in zip(gbuf, ref)),
            f"rasterize() torus262k@{SIZE}: G-buffer != plain-path frame")
    say("large", f"rasterize() torus262k@{SIZE}: G-buffer == plain-path frame")
    require(launches["binsort"] > 0 and launches["raster"] > 0
            and launches["sort"] == 0,
            f"the un-grouped path did not run on B4 + B1 alone: {launches}")
    say("large", f"kernel launches on the un-grouped path: {launches}")
    return launches, results


def time_frames(tag, renderer, model, n):
    """Median ms/frame (CUDA events) and mean wall ms of ``n`` warm frames."""
    import torch

    from cython3dmodelrenderer_tpu_torch.measure import cuda_time_ms

    ms = cuda_time_ms(lambda: renderer.render(model), n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        renderer.render(model)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n * 1e3
    say("timing", f"{tag}: {ms:.4f} ms/frame median (CUDA events, {n} warm "
        f"frames), {wall:.4f} ms/frame mean wall, {model.n_triangles()} "
        "triangles")
    return {"median_event_ms": ms, "mean_wall_ms": wall}


def phase_timing(scenes, results, inputs, light):
    from cython3dmodelrenderer_tpu_torch.measure import cuda_time_ms
    from cython3dmodelrenderer_tpu_torch.ops.raster import (raster_tiles,
                                                            raster_tiles_plain)
    from cython3dmodelrenderer_tpu_torch.ops.sort import sort_i32, sort_i32_plain

    frame_ms = {}
    for (name, iname), (renderer, *_rest) in results.items():
        frame_ms[f"{name}/{iname}"] = time_frames(f"{name} {iname}", renderer,
                                                  scenes[name], WARM_FRAMES)
    # the kernels at the main path's shapes: the 16k-triangle sphere's frame
    kw, keys = inputs["sphere16k"]["lambert_u8"]
    kt = {
        "sort": (cuda_time_ms(lambda: sort_i32(keys), 100),
                 cuda_time_ms(lambda: sort_i32_plain(keys), 100)),
        "raster": (cuda_time_ms(lambda: raster_tiles(**kw, light=light,
                                                  gbuffer=False, image=True),
                             100),
                   cuda_time_ms(lambda: raster_tiles_plain(**kw, light=light,
                                                        gbuffer=False,
                                                        image=True), 20)),
    }
    for k, (ms, plain) in kt.items():
        say("timing", f"{k}: kernel {ms:.4f} ms, plain {plain:.4f} ms "
            f"(sphere16k lambert_u8 frame: {keys.numel()} pair keys)")
    bounds = {"sort": sort_bound(keys), "raster": raster_bound(kw)}
    return frame_ms, kt, bounds


def phase_timing_large(scenes, results, inputs, light):
    """The un-grouped frames; B4 and the B3 route against their plain
    versions at torus262k@1024; both routes' binning at sphere16k@1024."""
    from cython3dmodelrenderer_tpu_torch.measure import cuda_time_ms
    from cython3dmodelrenderer_tpu_torch.ops.binsort import (bin_pairs,
                                                             bin_sort,
                                                             bin_sort_plain)
    from cython3dmodelrenderer_tpu_torch.ops.raster import (raster_tiles,
                                                            raster_tiles_plain)
    from cython3dmodelrenderer_tpu_torch.ops.sort import sort_i32

    frame_ms = {}
    for (name, size, iname), (renderer, *_rest) in results.items():
        frame_ms[f"{name}@{size}/{iname}"] = time_frames(
            f"{name}@{size} {iname}", renderer, scenes[name], LARGE_WARM_FRAMES)
    name, size = LARGE_FRAMES[1]                       # torus262k@1024
    spans = frame_setup(scenes[name], "lambert_u8", size)[1]
    kw = inputs[(name, size, "lambert_u8")]
    opts = dict(light=light, gbuffer=False, image=True)
    bounds = {"binsort": binning_bound(spans, bin_sort(*spans), spans[-1]),
              "b3_route": raster_bound(kw)}
    kt = {
        "binsort": (cuda_time_ms(lambda: bin_sort(*spans), 50),
                    cuda_time_ms(lambda: bin_sort_plain(*spans), 50)),
        "b3_route": (cuda_time_ms(lambda: raster_tiles(**kw, **opts), 50),
                     cuda_time_ms(lambda: raster_tiles_plain(**kw, **opts), 10)),
    }
    for k, (ms, plain) in kt.items():
        say("timing", f"{k}: kernel {ms:.4f} ms, plain {plain:.4f} ms "
            f"({name}@{size} lambert_u8: {spans[-1]} pairs)")
    small = frame_setup(scenes["sphere16k"], "lambert_u8", SIZE)[1]
    count_ms = cuda_time_ms(lambda: bin_sort(*small), 100)
    sort_ms = cuda_time_ms(lambda: bin_pairs(*small, sort=sort_i32), 100)
    say("timing", f"binning sphere16k@{SIZE} ({small[-1]} pairs): counting-sort "
        f"route (B4) {count_ms:.4f} ms, sort route (B2 + searchsorted) "
        f"{sort_ms:.4f} ms")
    kt["routes_sphere16k@1024"] = (count_ms, sort_ms)
    return frame_ms, kt, bounds


def turntable_model(device):
    """sphere16k in the README rotation, centred and unit-scaled without
    fit_model's z shift: the sweep poses it."""
    from cython3dmodelrenderer_tpu_torch import Model

    v, f = displaced_sphere(TRI_SPHERE_SEGMENTS, TRI_SPHERE_RINGS)
    model = Model(v, f, device=device)
    model.rotate([-90, 180, 0])
    model.rotate([10, -80, 0])
    model.shift(-model.get_mean_vertex())
    model.scale(1.0 / model.get_max_span())
    return model


def sweep_args(renderer, model, vb, fast=False):
    renderer.generator.manual_seed(7)
    return dict(model=model, angles=sweep_angles(), shifts=sweep_shifts(),
                view_batch=vb, fast_shade=fast)


def sweep_angles():
    from cython3dmodelrenderer_tpu_torch.parallel import multiview

    return multiview.turntable_angles(SWEEP_VIEWS)


def sweep_shifts():
    import numpy as np

    return np.broadcast_to(np.float32(SWEEP_SHIFT), (SWEEP_VIEWS, 3))


def phase_sweep(model, light):
    """The multi-view path through ``Renderer.render_sequence``."""
    import torch

    from cython3dmodelrenderer_tpu_torch import GuroIllumination, NoIllumination
    from cython3dmodelrenderer_tpu_torch.config import RenderConfig
    from cython3dmodelrenderer_tpu_torch.ops.binsort import bin_sort
    from cython3dmodelrenderer_tpu_torch.ops.raster import (raster_tiles,
                                                            render_frame)
    from cython3dmodelrenderer_tpu_torch.ops.sort import sort_i32
    from cython3dmodelrenderer_tpu_torch.parallel import multiview

    illums = (("guro", GuroIllumination([0, 0, 1])), ("none", NoIllumination()))
    runs = [(iname, vb, False) for iname, _ in illums for vb in SWEEP_BATCHES]
    runs += [("guro", vb, True) for vb in FAST_BATCHES]
    renderers = {iname: make_renderer(illum) for iname, illum in illums}
    counters = (raster_tiles, sort_i32, bin_sort)
    results, per_sweep = {}, {}
    for c in counters:
        c.launches = 0
    for iname, vb, fast in runs:                    # the sweep path's run
        before = [c.launches for c in counters]
        results[(iname, vb, fast)] = renderers[iname].render_sequence(
            **sweep_args(renderers[iname], model, vb, fast))
        per_sweep[(iname, vb, fast)] = [c.launches - b
                                        for c, b in zip(counters, before)]
    torch.cuda.synchronize()
    launches = {"raster": raster_tiles.launches, "sort": sort_i32.launches,
                "binsort": bin_sort.launches,
                "raster_batched": sum(n[0] for (_i, vb, _f), n in
                                      per_sweep.items() if vb > 1)}

    config = RenderConfig(height=SIZE, width=SIZE, fov=FOV)
    gen = torch.Generator().manual_seed(7)
    colors = torch.randint(256, (model.n_triangles(), 3), generator=gen)
    colors = colors.to(DEVICE, torch.float32)[:, None, :].expand(-1, 3, 3)
    colors = colors.contiguous()
    tv, tn = model.vertices_by_triangles, model.normals_by_triangles
    posed = [multiview._pose_triangles(tv, tn, a, s)
             for a, s in zip(sweep_angles(), sweep_shifts())]
    for (iname, vb, fast), imgs in results.items():
        tag = f"{iname} view_batch={vb}{' fast' if fast else ''}"
        require(imgs.shape == (SWEEP_VIEWS, SIZE, SIZE, 3)
                and imgs.dtype == torch.uint8, f"sweep {tag}: {imgs.shape}")
        require(torch.equal(imgs, results[(iname, 1, fast)]),
                f"sweep {tag}: differs from view_batch=1")
        n_b1, n_b2, n_b4 = per_sweep[(iname, vb, fast)]
        require(n_b1 == SWEEP_VIEWS // vb,
                f"sweep {tag}: B1 launched {n_b1} times, not N/V")
        want_route = (0, 1) if vb == 8 else (SWEEP_VIEWS // vb, 0)
        require((n_b2, n_b4) == want_route,
                f"sweep {tag}: B2/B4 launches {(n_b2, n_b4)}, want {want_route}")
        lit = float((imgs.amax(-1) > 0).float().mean())
        require(lit > 0.05, f"sweep {tag}: frames are empty ({lit})")
        say("sweep", f"{tag}: == view_batch=1, B1 x{n_b1}, B2 x{n_b2}, "
            f"B4 x{n_b4}, {lit:.4f} of pixels lit")
    for iname, fast in (("guro", False), ("none", False), ("guro", True)):
        post = ("fast_lambert_u8" if fast else
                "lambert_u8" if iname == "guro" else "u8")
        for v, (pv, pn) in enumerate(posed):
            img = render_frame(pv, pn, colors, config, post=post,
                               light=light if iname == "guro" else None,
                               backend="cuda", group=16)[1]
            require(torch.equal(img, results[(iname, 1, fast)][v]),
                    f"sweep {iname} {post} view {v}: != render_frame")
        say("sweep", f"{iname} {post}: all {SWEEP_VIEWS} views == render_frame "
            "on the same posed arrays")
    plain = make_renderer(GuroIllumination([0, 0, 1]), "torch")
    ref = plain.render_sequence(**sweep_args(plain, model, SWEEP_VIEWS))
    torch.cuda.synchronize()
    require(torch.equal(ref, results[("guro", SWEEP_VIEWS, False)]),
            "sweep guro view_batch=8: kernel sweep != plain-path sweep")
    say("sweep", f"guro view_batch={SWEEP_VIEWS}: == plain-path sweep")
    require(launches["raster_batched"] > 0 and launches["sort"] > 0
            and launches["binsort"] > 0,
            f"a kernel was not launched on the sweep path: {launches}")
    say("sweep", f"kernel launches on the sweep path: {launches}")
    return launches, renderers, colors


def sweep_batch_inputs(model, colors, post, vb=2):
    """The stacked rows and bins B1 gets from a view_batch=vb sweep batch."""
    from cython3dmodelrenderer_tpu_torch.config import RenderConfig
    from cython3dmodelrenderer_tpu_torch.ops import raster
    from cython3dmodelrenderer_tpu_torch.parallel import multiview

    config = RenderConfig(height=SIZE, width=SIZE, fov=FOV)
    rows, tx0, cx, ty0, cy, counts = multiview._stacked_planes(
        model.vertices_by_triangles, model.normals_by_triangles, colors,
        sweep_angles()[:vb], sweep_shifts()[:vb], config, lean=post == "u8")
    ntx, nty = SIZE // raster.TILE_W, SIZE // raster.TILE_H
    bins = raster.route_bins(tx0, cx, ty0, cy, ntx, nty, int(counts.sum()),
                             16, "cuda", vb)
    kw = dict(rows=rows, ntx=ntx, nty=nty, height=SIZE, width=SIZE,
              n_attrs=3 if post == "u8" else 6, z_init=config.z_init,
              n_views=vb)
    return with_bins(kw, bins)


def phase_kernels_sweep(model, colors, light):
    """B1's view-batched launch against its plain version (view_batch 2)."""
    import torch

    from cython3dmodelrenderer_tpu_torch.ops.raster import (raster_tiles,
                                                            raster_tiles_plain)

    err = 0.0
    for post in ("none", "u8", "lambert_u8"):
        kw = sweep_batch_inputs(model, colors, post)
        opts = dict(light=light if post == "lambert_u8" else None,
                    gbuffer=post == "none", image=post != "none")
        g_k, i_k = raster_tiles(**kw, **opts)
        g_p, i_p = raster_tiles_plain(**kw, **opts)
        torch.cuda.synchronize()
        pairs = list(zip(g_k, g_p)) if post == "none" else [(i_k, i_p)]
        err = max([err] + [float((a.float() - b.float()).abs().max())
                           for a, b in pairs])
        require(all(torch.equal(a, b) for a, b in pairs),
                f"B1 view-batched {post}: differs from the plain version")
        say("kernels", f"B1 view-batched (2 views) sphere16k {post}: bit-equal "
            f"({int(kw['pair_tri'].numel())} pairs)")
    return err


def phase_timing_sweep(renderers, model, colors, light, frame_ms):
    """ms per view of each sweep (CUDA events over the sweep / N) beside
    the single-frame ms/frame, and B1 view-batched against its plain
    version at view_batch 2."""
    from cython3dmodelrenderer_tpu_torch.measure import cuda_time_ms
    from cython3dmodelrenderer_tpu_torch.ops.raster import (raster_tiles,
                                                            raster_tiles_plain)

    out = {}
    for iname, renderer in renderers.items():
        single = frame_ms[f"sphere16k/{iname}"]["median_event_ms"]
        for vb in SWEEP_BATCHES:
            args = sweep_args(renderer, model, vb)
            ms = cuda_time_ms(lambda: renderer.render_sequence(**args), SWEEP_REPS)
            out[f"sweep_{iname}_vb{vb}"] = ms / SWEEP_VIEWS
            say("timing", f"sweep {iname} view_batch={vb}: "
                f"{ms / SWEEP_VIEWS:.4f} ms/view ({SWEEP_VIEWS} views, median "
                f"of {SWEEP_REPS} sweeps, CUDA events); single frame "
                f"{single:.4f} ms/frame")
    for vb in FAST_BATCHES:
        args = sweep_args(renderers["guro"], model, vb, fast=True)
        ms = cuda_time_ms(lambda: renderers["guro"].render_sequence(**args),
                       SWEEP_REPS)
        out[f"sweep_guro_fast_vb{vb}"] = ms / SWEEP_VIEWS
        say("timing", f"sweep guro fast view_batch={vb}: "
            f"{ms / SWEEP_VIEWS:.4f} ms/view")
    kw = sweep_batch_inputs(model, colors, "lambert_u8")
    opts = dict(light=light, gbuffer=False, image=True)
    kt = (cuda_time_ms(lambda: raster_tiles(**kw, **opts), 100),
          cuda_time_ms(lambda: raster_tiles_plain(**kw, **opts), 10))
    say("timing", f"B1 view-batched (2 views, lambert_u8, "
        f"{int(kw['pair_tri'].numel())} pairs): kernel {kt[0]:.4f} ms, plain "
        f"{kt[1]:.4f} ms")
    return out, kt, raster_bound(kw)


def phase_b5(scenes):
    """B5 against its plain version at sphere16k@1024²'s spans."""
    import torch

    from cython3dmodelrenderer_tpu_torch.measure import cuda_time_ms
    from cython3dmodelrenderer_tpu_torch.ops.binsort_grouped import (
        bin_sort_grouped, bin_sort_grouped_plain)

    tx0, cx, ty0, cy, ntx, nty, total = frame_setup(scenes["sphere16k"],
                                                    "lambert_u8", SIZE)[1]
    spans = (tx0, cx, ty0, cy, ntx, nty)
    demand = int(bin_sort_grouped_plain(*spans, 1 << 16, B5_GROUP, B5_SUB)[6])
    caps = (("ample", demand), ("undersized", 128 * (total // 256)))
    bin_sort_grouped.launches = 0                   # B5's own run
    runs = [bin_sort_grouped(*spans, cap, B5_GROUP, B5_SUB) for _t, cap in caps]
    torch.cuda.synchronize()
    launches = bin_sort_grouped.launches
    require(launches > 0, "B5 was not launched")
    err = 0
    for (tag, cap), got in zip(caps, runs):
        again = bin_sort_grouped(*spans, cap, B5_GROUP, B5_SUB)
        want = bin_sort_grouped_plain(*spans, cap, B5_GROUP, B5_SUB)
        torch.cuda.synchronize()
        err = max([err] + [int((a - b).abs().max()) for a, b in zip(got, want)])
        require(all(torch.equal(a, b) for a, b in zip(got, want)),
                f"B5 {tag}: differs from the plain version")
        require(all(torch.equal(a, b) for a, b in zip(got, again)),
                f"B5 {tag}: two runs differ")
        placed = int((got[0] != tx0.shape[0]).sum())
        require(0 < placed <= min(total, cap), f"B5 {tag}: {placed} placed")
        say("b5", f"bin_sort_grouped {tag} (slot_cap {cap}, {total} pairs, "
            f"{placed} placed, total_slots {int(got[6])}): bit-equal to plain "
            "in every output, deterministic")
    cap = caps[0][1]
    kt = (cuda_time_ms(lambda: bin_sort_grouped(*spans, cap, B5_GROUP, B5_SUB), 50),
          cuda_time_ms(lambda: bin_sort_grouped_plain(*spans, cap, B5_GROUP,
                                                   B5_SUB), 50))
    say("timing", f"B5 bin_sort_grouped sphere16k@{SIZE} ({total} pairs, "
        f"slot_cap {cap}): kernel {kt[0]:.4f} ms, plain {kt[1]:.4f} ms")
    return launches, err, kt, binning_bound(spans, runs[0], total)


def max_abs_err(got, want):
    """Largest |got - want| over the elements that differ (inf == inf)."""
    differ = got != want
    return float((got - want).abs()[differ].max()) if differ.any() else 0.0


def phase_probes():
    """The calibration probes: their path as the scripts run it (counts
    set to 0 just before, read just after), then each kernel against its
    plain version, and the timings of the kernels line."""
    import numpy as np
    import torch

    from cython3dmodelrenderer_tpu_torch.measure import (cuda_time_ms,
                                                         roofline_ms)
    from cython3dmodelrenderer_tpu_torch.probes import epi_prims, vpu_cal

    x2 = vpu_cal.make_input(device=DEVICE)
    x1, smat = epi_prims.make_input(DEVICE)
    vpu_cal.run_once.launches = epi_prims.run.launches = 0
    cal = vpu_cal.calibrate(x2)
    vpu_cal.report(cal)
    slopes = {}
    for name in epi_prims.ALL_PRIMS:
        slopes[name] = epi_prims.measure(name, x1, smat)
        epi_prims.report(name, *slopes[name])
    torch.cuda.synchronize()
    launches = {"vpu_cal": vpu_cal.run_once.launches,
                "epi_prims": epi_prims.run.launches}
    require(min(launches.values()) > 0,
            f"a probe kernel was not launched on the probes' path: {launches}")
    say("probes", f"kernel launches on the probes' path: {launches}")

    p2_err = 0.0
    for n_ops in P2_CHECK_N_OPS:
        got, again = vpu_cal.run_once(x2, n_ops), vpu_cal.run_once(x2, n_ops)
        want = vpu_cal.run_once_plain(x2, n_ops)
        torch.cuda.synchronize()
        p2_err = max(p2_err, max_abs_err(got, want))
        require(torch.equal(got, want), f"P2 n_ops={n_ops}: != plain")
        require(torch.equal(got, again), f"P2 n_ops={n_ops}: two runs differ")
        say("probes", f"P2 vpu_cal n_ops={n_ops}: bit-equal to plain, "
            f"deterministic ({int(torch.isinf(got).sum())} of "
            f"{got.numel()} elements overflow to inf on both)")
    p1_err = 0.0            # the checked difference: one replica's
    for name in epi_prims.ALL_PRIMS:
        # every replica sees the same tile (x + rep * 1e-30 rounds to x), so
        # R replicas are R f32 adds of the one-replica value, in order, on
        # both sides: kernel(R) and plain(R) are the same fold of two
        # one-replica values held to each other
        one_k = np.float32(epi_prims.run(name, 1, x1, smat).item())
        one_p = np.float32(epi_prims.run_plain(name, 1, x1, smat).item())
        exact = name in epi_prims.ELEMENT_PRIMS
        require(one_k == one_p if exact
                else abs(one_k - one_p) <= P1_RTOL * abs(one_p),
                f"P1 {name}: one replica, kernel {one_k!r} vs plain {one_p!r}")
        p1_err = max(p1_err, float(abs(one_k - one_p)))
        gaps = []
        for reps in P1_CHECK_REPS:
            got = epi_prims.run(name, reps, x1, smat)
            again = epi_prims.run(name, reps, x1, smat)
            want = epi_prims.run_plain(name, reps, x1, smat)
            torch.cuda.synchronize()
            g, w = got.item(), want.item()
            require(torch.equal(got, again),
                    f"P1 {name} reps={reps}: two runs differ")
            for side, value, one in (("kernel", g, one_k), ("plain", w, one_p)):
                fold = np.float32(0.0)
                for _ in range(reps):
                    fold = np.float32(fold + one)
                require(value == fold, f"P1 {name} reps={reps}: {side} "
                        f"{value!r}, {reps} adds of its one-replica value "
                        f"{float(fold)!r}")
            tol = 0.0 if exact else (P1_RTOL + reps * P1_FOLD_ULP) * abs(w)
            require(abs(g - w) <= tol, f"P1 {name} reps={reps}: kernel {g!r} "
                    f"vs plain {w!r}, beyond {tol!r}")
            gaps.append(abs(g - w))
        say("probes", f"P1 epi_prims {name}: one replica "
            f"{'bit-equal' if exact else f'within {abs(one_k / one_p - 1):.1e}'}"
            f" to plain; reps {P1_CHECK_REPS}: kernel and plain each == that "
            f"many f32 adds of their one-replica value, |kernel - plain| "
            f"{gaps}; deterministic")

    p2_ms = cal["ms"][P2_TIMED]
    p2_plain = cuda_time_ms(lambda: vpu_cal.run_once_plain(x2, P2_TIMED), 1,
                            warmup=0)
    name, reps = P1_TIMED
    p1_ms = cuda_time_ms(lambda: epi_prims.run(name, reps, x1, smat), 20)
    p1_plain = cuda_time_ms(lambda: epi_prims.run_plain(name, reps, x1, smat),
                            2, warmup=1)
    v = x1.reshape(-1, epi_prims.K)
    mm = {"segsum": cuda_time_ms(lambda: torch.matmul(v, smat), 50),
          "segsum6": cuda_time_ms(lambda: torch.matmul(v.repeat(6, 1), smat),
                                  50)}
    for k, ms in mm.items():
        say("probes", f"{k}: kernel {slopes[k][0]:.3f} us a replica; "
            f"torch.matmul (f32, TF32 off) of the same product {ms * 1e3:.3f} "
            "us a call (yardstick)")
    say("timing", f"P2 vpu_cal n_ops={P2_TIMED}: kernel {p2_ms:.4f} ms, plain "
        f"{p2_plain:.4f} ms; P1 {name} reps={reps}: kernel {p1_ms:.4f} ms, "
        f"plain {p1_plain:.4f} ms")
    steps = x2.shape[0] * x2[0].numel()
    bounds = {
        # x read and the accumulator written once; per element and step the
        # chain's FMUL, FADD, FSETP and predicated FADD per pair and the
        # carry's multiply and add
        "vpu_cal": roofline_ms(nbytes(x2, x2[0]),
                               steps * (P2_TIMED // 2 * 4 + 2)),
        # x and smat read once, the scalar written once; the operations of
        # the 16 lanes a row that can contribute
        "epi_prims": roofline_ms(
            nbytes(x1, smat) + 4,
            reps * x1[..., 0].numel() * epi_prims.EPI_CUR6_OPS_PER_ROW),
    }
    probes = {"vpu_cal": {"ms": cal["ms"], "ns_per_op": cal["ns_per_op"],
                          "instr_per_s": cal["instr_per_s"]},
              "epi_prims_us_per_replica": {k: v[0] for k, v in slopes.items()},
              "epi_prims_walls_ms": {k: v[1] for k, v in slopes.items()},
              "matmul_us": {k: ms * 1e3 for k, ms in mm.items()}}
    times = {"vpu_cal": (p2_ms, p2_plain), "epi_prims": (p1_ms, p1_plain)}
    return launches, {"vpu_cal": p2_err, "epi_prims": p1_err}, times, \
        bounds, probes


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
        frame_ms, kt, bounds = phase_timing(scenes, results, inputs, light)
        large = load_large_scenes("cuda", scenes)
        binsort_err, b3_err, large_inputs = phase_kernels_large(large, light)
        large_launches, large_results = phase_large(large)
        large_ms, large_kt, large_bounds = phase_timing_large(
            large, large_results, large_inputs, light)
        tt_model = turntable_model(DEVICE)
        sweep_launches, sweep_renderers, sweep_colors = phase_sweep(tt_model,
                                                                    light)
        sweep_err = phase_kernels_sweep(tt_model, sweep_colors, light)
        sweep_ms, sweep_kt, sweep_bound = phase_timing_sweep(
            sweep_renderers, tt_model, sweep_colors, light, frame_ms)
        b5_launches, b5_err, b5_kt, b5_bound = phase_b5(scenes)
        (probe_launches, probe_err, probe_ms, probe_bounds,
         probes) = phase_probes()
    except SmokeFailure as e:
        print(f"FAIL: {e}", flush=True)
        return 1
    frame_ms.update(large_ms)
    frame_ms["sweep_ms_per_view"] = sweep_ms
    frame_ms["binning_routes_sphere16k@1024"] = {
        "counting_sort_ms": large_kt["routes_sphere16k@1024"][0],
        "sort_searchsorted_ms": large_kt["routes_sphere16k@1024"][1]}

    def entry(name, source, replaces, n, err, times, bound, library=None):
        return {"name": name, "route": "cuda",
                "source": f"cython3dmodelrenderer_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": n, "max_abs_err": err,
                "ms": times[0], "plain_ms": times[1], "bound_ms": bound[0],
                "bound_by": bound[1], "library_ms": library}

    pkg = "cython3dmodelrenderer_tpu/ops/"
    kernels = [
        entry("raster_tiles (B1)", "raster.cu", pkg + "raster_pallas.py:293",
              launches["raster"], raster_err, kt["raster"], bounds["raster"]),
        # B2's plain version is torch.sort itself: its time is the library's
        entry("sort_i32 (B2)", "sort.cu", pkg + "sort_pallas.py:32",
              launches["sort"], sort_err, kt["sort"], bounds["sort"],
              library=kt["sort"][1]),
        entry("bin_sort (B4)", "binsort.cu", pkg + "binsort_pallas.py:42",
              large_launches["binsort"], binsort_err, large_kt["binsort"],
              large_bounds["binsort"]),
        entry("raster_tiles on bin_sort bins (B3)", "raster.cu",
              pkg + "raster_pallas.py:142", large_launches["raster"], b3_err,
              large_kt["b3_route"], large_bounds["b3_route"]),
        entry("raster_tiles view-batched (B1/B3 tiles_per_view)", "raster.cu",
              pkg + "raster_pallas.py:293", sweep_launches["raster_batched"],
              sweep_err, sweep_kt, sweep_bound),
        entry("bin_sort_grouped (B5)", "binsort_grouped.cu",
              pkg + "binsort_pallas.py:106", b5_launches, b5_err, b5_kt,
              b5_bound),
        entry("vpu_cal (P2)", "vpu_cal.cu", "tools/probes/vpu_cal.py:51",
              probe_launches["vpu_cal"], probe_err["vpu_cal"],
              probe_ms["vpu_cal"], probe_bounds["vpu_cal"]),
        entry("epi_prims epi_cur6 x128 (P1)", "epi_prims.cu",
              "tools/probes/epi_prims.py:275", probe_launches["epi_prims"],
              probe_err["epi_prims"], probe_ms["epi_prims"],
              probe_bounds["epi_prims"]),
    ]
    print(json.dumps({"frame_ms": frame_ms}), flush=True)
    print(json.dumps({"probes": probes}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
