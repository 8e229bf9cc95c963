#!/usr/bin/env python3
"""GPU smoke test of cython3dmodelrenderer_tpu_torch (PyTorch + CUDA port).

Run from the repository root on a machine with an NVIDIA GPU:

    python3 chip_smoke.py

Phases (one line each; any failure exits nonzero):

1. device  — torch/CUDA versions and the card's name and power limit;
             fails when CUDA is unavailable (no CPU fallback);
2. build   — builds kernels B1 (csrc/raster.cu), B2 and B4 (the radix-sort
             core, csrc/radix_sort.cu), B5 (csrc/binsort_grouped.cu), P2
             (csrc/vpu_cal.cu), P1 (csrc/epi_prims.cu), F1 (the front
             end, csrc/frontend.cu) and the fallback colours' expansion
             (csrc/colors.cu) from the repository's sources, one nvcc
             each, all started together;
3. kernels — each kernel against its plain PyTorch version on the card:
             B2 (exact, and equal to itself on a second call) on keys
             with duplicates at 0 to 2^18 + 17 keys, both sides of the
             one-launch limit, at 25 bits and 31 (with INT32_MAX), on all
             keys equal, and on each scene's pair keys at their width; B1
             on the binned 1024² scenes for posts none/u8/lambert_u8 and on
             hand-made rows at 40 x 80 (merge_case: -0.0 and +0.0 winners,
             exact z ties, z exactly 0 and 1, NaN rows, empty and outside
             bboxes, ±inf, huge and fractional bounds); every B1 check here
             and below is bit for bit (-0.0 is not +0.0) and equal to
             itself on a second call; F1 bit for bit in every output (NaN
             bits too) and equal to itself, with 0, 3 and 6 attribute
             channels and fast shade, on every scene at 1024², on a
             seeded edge scene (a vertex on the camera plane, a NaN x, a
             degenerate, a backfacing, an off-screen and a huge clipped
             triangle) at 1024² and 72 x 100 and posed in 3 views, cut to
             1, 127, 128, 129, 257 and 259 triangles (around F1's block of
             128) and posed in 3 views at 45 and 200, and on
             no triangles (phases 6 and 7 add the large frames and the
             sweep's posed batches of 4 and 8 views); the fallback
             colours' expansion (csrc/colors.cu) bit for bit on the same
             pinned bytes as its plain version, at 0 to 871,824 triangles
             (igor_sphere's 6,016 and the Dragon's 871,824), on a stream
             given and on the current one, then its ms and the plain
             version's (a copy and an expand) at those two counts;
4. main    — Renderer.render at 1024², fov 45, with GuroIllumination and
             NoIllumination, on (a) assets/igor_sphere.obj, (b) a
             16,128-triangle displaced UV sphere built in memory and
             (c) $CRENDER_OBJECTS/T-Rex.obj when that file exists; checks
             the images against the plain path, determinism, the lazy
             z-buffer and that B4 and B1 launched (the counting-sort
             route, which every frame takes) and B2 not, F1 once a
             frame (as many launches as B1) and csrc/colors.cu once an
             untextured frame, and never on the plain path;
             one Renderer, filler and model built with no device
             argument must render on the card (the default device);
5. timing  — median steady-state ms/frame of 60 warm frames per scene
             (CUDA events), and each kernel against its plain version (B1
             and F1 also device ms and device operations a call, F1's
             required to be 1 (2 for the sweep's batch: the poses' copy),
             and F1's bound fraction; F1 at sphere16k's 6 and 3 channels;
             F1's built threads, shared memory, registers and spills
             against its launch plan in phase 3);
             B2 at sphere16k@1024²'s 17,473 pair keys beside torch.sort,
             with device ms and device operations a call (torch.profiler);
6. large   — the un-grouped (counting-sort) path: B4 against its plain
             version (bit-equal, and equal to itself on a second run) on
             the spans of sphere16k@2048², torus262k@1024² and @4096² (a
             262,144-triangle displaced torus built in memory) and on 0
             and 1 pairs, and with every pair in one tile (1,000 and
             200,000 triangles); B1 on B4's bins (the B3 route) against
             the plain raster, and on the one-tile bins of 1,000 and 200,000
             candidates (one_tile_rows); Renderer.render on those three frames with
             both illuminations, checked as in phase 4, B4 and B1 launched
             and B2 not, F1 once a frame; rasterize() once; F1 against its
             plain version on the three frames; then their ms/frame (20 warm
             frames), B4's whole wrapper at torus262k@1024² and @4096²
             (with torch.sort of the same pairs' tile ids, the sort step
             alone, as a yardstick) and the B3 route against their plain
             versions (the B3 route also device ms and operations a call),
             and both routes' binning at sphere16k@1024²; B1 launched
             once a frame counts once more for a frame that overflowed
             B4's capacity and ran again (bins_capacity_reruns);
   capacity — B4 sized from the grid's capacity, the pair total read
             after B1's launch: a 984 x 443 displaced torus (871,824
             triangles, the Dragon's size) in 16 tilted turntable poses
             at 1024², lit, through the filler from capacity 0: every
             image bit-equal to the read-first frame (F1, the read, B4
             sized exactly, B1), its pairs, stats, validate_capacity and
             frame_provisional as before, the capacity whole sort tiles
             at or over every total seen; the first pass re-runs, a
             second only fits; then host-clock ms a frame of both orders
             (render_frame and the read-first frame), each frame
             synchronised, 8 rounds of 4 x 16 poses in turns;
7. sweep   — the multi-view path: an 8-view turntable of sphere16k at
             1024² through Renderer.render_sequence with GuroIllumination
             and NoIllumination at view_batch 1, 2, 4 and 8 (each once to
             warm B4's capacity, then checked; all on the
             counting-sort route: B4 once a batch, B2 never), fast shade
             at 1 and 4; every view equal to its
             view_batch=1 render and to render_frame on the same posed
             arrays, B1 and F1 launched N/V times a sweep, one view_batch=8
             sweep equal to the plain path; B1's view-batched launch
             against its plain version at view_batch 2 and on a 2-view
             merge case, F1 on the posed batches of 4 and 8 views; then ms
             per view per view_batch (CUDA events over the sweep / N), B1's
             view-batched time with its device ms, F1's on the 4-view batch,
             and B2 at the view_batch=4 batch's pair keys beside
             torch.sort;
8. b5      — B5 (B4's bins, then csrc/binsort_grouped.cu; on no render
             path) on sphere16k@1024²'s spans, group 16, sub 8, at an
             ample, an undersized and a mid-span slot_cap (the expansion
             cut inside a triangle's span, checked): B4, B2 and the
             placement each launched once a call; bit-equal in all 8
             outputs to bin_sort_grouped_plain and place_from_bins_plain,
             equal to itself on a second run; at the first two caps its
             time, device ms and device operations a call, and the plain
             version's time;
9. probes  — the calibration probes' path, as their ``__main__``s run it:
             P2 (probes/vpu_cal.py) at n_ops 8/32/128/512 and P1
             (probes/epi_prims.py), all 15 primitives at 0/128/256
             replicas, printed as the scripts print them; then P2 against
             its plain version at n_ops 8, 32 and 512 (bit-equal, equal to
             itself on a second run) and P1 at 0, 2, 128 and 129
             replicas (on P1's grid of up to 64 x 32 blocks): one
             replica bit-equal to the plain version for the element
             primitives and within rtol 2e-6 for the summed ones (up to
             2 x 65,536 floats summed in another order); at R replicas
             the kernel and the plain version each equal bit for bit to
             R f32 adds of their own one-replica value, and the kernel
             equal to the plain version (element primitives) or within
             rtol 2e-6 + R x 2^-23 (the rest); equal to itself on a second
             run; torch.matmul beside segsum / segsum6 as a yardstick;
             P1 epi_cur6 x 128 and P2 n_ops 512 in device ms and device
             operations a call;
10. surface — the Renderer surface beyond the batched frame, on the card:
             the "ratio" backend (ops/raster_ref.py) at 1024², Guro and
             None, on igor_sphere and sphere16k, within
             test_golden_standalone's bounds of the kernel frame (z
             mismatch fraction printed), and at 512² bit-equal to the
             same render on CPU tensors and to itself; render_turntable
             over sphere16k's 8 sweep poses, each view bit-equal to
             render_view of its posed arrays; all igor_sphere triangles
             at 1024² through compute_triangle_statistics on CUDA
             Buffers against the ratio frame; a custom IlluminationDrawer
             through Renderer.render on the cuda backend (B1 launched)
             equal to cast_u8(drawer.apply(...)) of snapshot_buffers() and
             to the plain path; the LineBresenham wireframe of sphere16k
             at 1024² (edges and vertices) bit-equal to fill_all on CPU
             tensors, and a recording LineDrawer seeing 3·T cube edges;
             ms/frame (10 warm frames, CUDA events), ms/view and ms per
             triangle, printed as the ``surface`` JSON line;
11. sharded — parallel/multiview.py over torch.distributed on the one card,
             at world size 1 (in process, NCCL) and 2 (two spawned ranks on
             cuda:0, gloo, whose collectives take CUDA tensors; a rank that
             raises fails the spawn and the smoke): the view-sharded
             8-view sphere16k turntable on the cuda backend at view_batch 1
             and 4, each rank's views bit-equal to the unsharded sweep's
             and B1 and F1 launched N/(D·V) times on every rank; torus262k
             triangle-sharded, the merged z bit-equal to the unsharded
             frame's, colour and normal too (+0.0 for a winner's -0.0 at
             2 ranks), F1 once, B4 and B1 launched on every rank and B2
             not; the
             ratio backend at 512², view- and triangle-sharded, against
             its unsharded render; ms/view, ms/frame (CUDA events, median
             of 5) beside the unsharded ones; then examples/multichip.py
             at 2 ranks on the card (its own sharded == unsharded checks,
             gathered over gloo); the ``sharded`` JSON line;
12. host    — the native OBJ parser (must build: the card's host has g++)
             equal to the Python parser on assets/*.obj and on sphere16k
             and torus262k written out as OBJ, with both parsers' ms; the
             compat crender.cy.Renderer at 1024² on igor_sphere (host
             float32 == the filler's G-buffers shaded; cast to uint8 == the
             port Renderer's frame); utils.timing.time_frames beside
             measure.cuda_time_ms on a sphere16k frame; the turntable
             example at 8 views without writing PNGs, equal to the sweep;
             the ``host`` JSON line.

The ``surface``, ``sharded`` and ``host`` JSON lines carry their phase's
numbers beside the card's nvidia-smi name and power limit. The next-to-last lines are the nvidia-smi
name/power-limit line and one
JSON object with the kernels' launch counts, errors, times and bounds
(``bound_ms``: the larger of the bytes moved over 3.35 TB/s and the f32
operations this run's inputs need over 33.5 T instructions/s; P1's
``max_abs_err`` is the one-replica difference that its checks hold; the
three B1/B3 entries, B5, P1, P2 and the three F1 entries (sphere16k and
torus262k at 1024², 6 channels, and the sweep's 4-view batch) also carry
``device_ms`` and ``device_ops``; the two entries of the colours'
expansion are bound by bytes, the PCIe read or the card's write); the last line is ``{"ok": true,
"device": {...}}``.
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
POSTS = ("none", "u8", "lambert_u8")
TRI_SPHERE_SEGMENTS, TRI_SPHERE_RINGS = 128, 64
TORUS_QUADS = (512, 256)           # 262,144 triangles
KERNEL_SOURCES = ("radix_sort", "raster", "binsort_grouped", "vpu_cal",
                  "epi_prims", "frontend", "colors")
# B2's checks: key counts and (key width, sort bits)
SORT_CHECK_SIZES = (0, 1, 2, 1000, 17473, 78000, (1 << 17) - 1, 1 << 17,
                    (1 << 17) + 1, (1 << 18) + 17)
SORT_CHECK_WIDTHS = ((25, 25), (25, 31), (31, 31))
ONE_TILE_TRIS = (1000, 200000)
MERGE_SEEDS = (0, 1)                # B1's hand-made merge cases
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
P1_CHECK_REPS = (0, 2, 128, 129)   # 129: no power-of-two chunk divides it
P1_RTOL = 2e-6           # summed primitives: up to 2 x 65,536 floats
# R replicas: each of R f32 adds rounds by at most half an ulp of the
# running sum, R x 2^-24 relative on each side
P1_FOLD_ULP = 2.0 ** -23
P1_TIMED = ("epi_cur6", 128)
SURFACE_WARM_FRAMES = 10
SURFACE_CPU_SIZE = 512             # the ratio frame held to a CPU render
# the sharded phase: world sizes on the one card (1: in process, NCCL;
# 2: two spawned ranks on cuda:0, gloo), the sweep's view batches, the
# ratio backend's size and the timed calls a case
SHARD_WORLDS = (1, 2)
SHARD_VIEW_BATCHES = (1, 4)
SHARD_RATIO_SIZE = 512
SHARD_REPS = 5
# F1 (the front end): (tag, attribute channels, fast shade), and the edge
# scene's frames (height, width)
FRONTEND_VARIANTS = (("geometry", 0, False), ("lean", 3, False),
                     ("full", 6, False), ("fast", 3, True))
FRONTEND_OUTPUTS = ("rows", "tx0", "cx", "ty0", "cy", "counts", "total")
FRONTEND_EDGE_FRAMES = ((SIZE, SIZE), (72, 100))
# triangle counts around F1's block of 128: one, a block less one, a block,
# a block and one, two and one, and a 3-row tail (no whole 16-byte chunks)
FRONTEND_COUNTS = (1, 127, 128, 129, 257, 259)
# csrc/colors.cu's checks (around its block of 256) and its timed counts
COLORS_CHECK_SIZES = (0, 1, 255, 256, 257, 6016, 871_824)
COLORS_TIMED = (("igor6k", 6016), ("dragon871k", 871_824))
PCIE_BYTES_PER_S = 64e9            # PCIe 5.0 x16, one direction
# B4's capacity: a Dragon-sized displaced torus (871,824 triangles) in a
# 16-pose turntable at 1024², tilted, at this depth; timed rounds of 4
# passes over the 16 poses a side, in turns
CAPACITY_TORUS = (984, 443)
CAPACITY_POSES = 16
CAPACITY_TILT, CAPACITY_SHIFT = -60.0, (0.0, 0.0, 3.0)
CAPACITY_ROUNDS, CAPACITY_PASSES = 8, 4


class SmokeFailure(Exception):
    pass


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def launch_counts(*kernels):
    """The program's kernel launches so far (``utils.timing.counters``,
    ``launch.<kernel>``), by kernel; ``"reruns"`` counts the frames and
    view batches that overflowed B4's capacity and ran B4 and B1 again
    (``bins_capacity_reruns``)."""
    from cython3dmodelrenderer_tpu_torch.utils.timing import counters

    return {k: counters["bins_capacity_reruns" if k == "reruns"
                        else f"launch.{k}"] for k in kernels}


def launches_since(before):
    """The launches of ``before``'s kernels since ``before`` was taken
    (``launch_counts``)."""
    now = launch_counts(*before)
    return {k: now[k] - n for k, n in before.items()}


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


def plane_rows(rng, n, cx, cy, radius, n_attrs=6):
    """``n`` plane rows (binning's layout) of triangle-like regions: three
    λ half-planes at 120° around (cx, cy) (arrays of n), a sloped z plane
    that crosses the [0, 1] range, random attribute planes, and a
    fractional bbox around the region."""
    import numpy as np

    rows = np.zeros((n, 16 + 3 * n_attrs), np.float32)
    theta = rng.uniform(0, 2 * np.pi, n)
    for i in range(3):
        nx, ny = np.cos(theta + 2 * np.pi * i / 3), np.sin(theta + 2 * np.pi * i / 3)
        r = radius * rng.uniform(0.3, 1.0, n)
        rows[:, 3 * i:3 * i + 3] = np.stack([-nx, -ny, r + nx * cx + ny * cy], 1)
    slope = rng.uniform(-0.02, 0.02, (n, 2))
    rows[:, 9:12] = np.stack([slope[:, 0], slope[:, 1],
                              rng.uniform(-0.1, 1.1, n) - slope[:, 0] * cx
                              - slope[:, 1] * cy], 1)
    rows[:, 12:16] = np.stack([cx - 2 * radius, cx + 2 * radius,
                               cy - 2 * radius, cy + 2 * radius], 1)
    attrs = rng.uniform(-0.5, 0.5, (n, n_attrs, 3))
    attrs[:, :3, 2] = rng.uniform(0, 255, (n, 3))
    attrs[:, 3:, 2] = rng.uniform(-1, 1, (n, n_attrs - 3))
    rows[:, 16:] = attrs.reshape(n, -1)
    return rows


def merge_case(device, n_views=1, seed=0):
    """Hand-made plane rows and bins for B1's merge rule at a 40 x 80 frame
    (partial edge tiles both ways; 80 is not a multiple of 32): random
    regions, then rows with z = -0.0 and +0.0 over the same pixels (both
    orders), exact z ties (a row's z plane copied into overlapping rows),
    z exactly 0 and 1, NaN in every column group, empty bboxes, bboxes past
    the frame, ±inf, huge and fractional bounds. Each (view, tile) bin holds
    the special rows and a random subset of the rest, ascending. Returns
    ``raster_tiles``' keyword arguments."""
    import numpy as np
    import torch

    height, width = 40, 80
    ntx, nty = -(-width // 32), -(-height // 16)
    rng = np.random.default_rng(seed)
    rows = plane_rows(rng, 48, rng.uniform(-10, 90, 48),
                      rng.uniform(-5, 45, 48), rng.uniform(3, 30, 48))
    # rows 48-53 overlap in a chain: -0.0 (48) then +0.0 (50) then -0.0
    # (53) over shared pixels; 54-56 tie; 57-61 never cover a pixel
    wide = plane_rows(
        rng, 14, np.float32([25, 8, 35, 70, 60, 45, 55, 58, 52] + [40] * 5),
        np.float32([20, 34, 20, 8, 30, 20, 25, 22, 28] + [20] * 5),
        np.float32([12, 8, 12, 10, 8, 12, 18, 18, 18] + [60] * 5))
    wide[:, 12:16] = [-1e30, 1e30, -np.inf, np.inf]
    wide[0, 9:12] = wide[1, 9:12] = wide[5, 9:12] = -0.0   # z == -0.0
    wide[2, 9:12] = wide[4, 9:12] = 0.0                      # z == +0.0
    wide[3, 9:12] = [0.0, 0.0, 1.0]                          # z == 1 exactly
    wide[6, 9:12] = wide[7, 9:12] = wide[8, 9:12]            # exact ties
    wide[6, 12:16] = [3.5, 70.25, 2.75, 39.5]                # fractional
    wide[9, :] = np.nan                                      # NaN row
    wide[10, 0:9] = np.nan                                   # NaN λ
    wide[11, 9:12] = np.nan                                  # NaN z
    wide[12, 12:16] = [np.nan, 50.0, 0.0, 40.0]              # NaN bbox
    wide[13, 12:16] = [np.inf, np.inf, -np.inf, np.inf]      # no x at all
    rows[40:48, 12:16] = [[20, 20, 0, 40], [30, 10, 0, 40], [0, 80, 9, 9],
                          [100, 200, 0, 40], [0, 80, -30, -1],
                          [-1e30, -1e29, 0, 40], [0, 80, 1e30, np.inf],
                          [np.inf, -np.inf, 0, 40]]          # empty or outside
    rows = np.concatenate([rows, wide])
    special = np.arange(40, rows.shape[0])
    bins = []
    for _ in range(ntx * nty * n_views):
        pick = rng.random(40) < 0.5
        bins.append(np.sort(np.concatenate([np.flatnonzero(pick), special])))
    counts = np.array([len(b) for b in bins], np.int32)
    starts = np.cumsum(counts) - counts

    def dev(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a).astype(dtype)).to(device)

    return dict(rows=dev(rows, np.float32),
                pair_tri=dev(np.concatenate(bins), np.int32),
                tile_starts=dev(starts, np.int32),
                tile_counts=dev(counts, np.int32), ntx=ntx, nty=nty,
                height=height, width=width, n_attrs=6, z_init=1e6,
                n_views=n_views)


def one_tile_rows(n_tris, ntx, nty, device, seed=0):
    """Plane rows of ``n_tris`` triangles around tile (ntx // 2, nty // 3)
    of an ntx x nty grid (``one_tile_spans``' tile), a quarter with flat
    z planes on 64 levels: exact ties among thousands of candidates."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    x0, y0 = (ntx // 2) * 32, (nty // 3) * 16
    rows = plane_rows(rng, n_tris, rng.uniform(x0 - 8, x0 + 40, n_tris),
                      rng.uniform(y0 - 4, y0 + 20, n_tris),
                      rng.uniform(2, 24, n_tris))
    flat = rng.random(n_tris) < 0.25
    rows[flat, 9:11] = 0.0
    rows[flat, 11] = rng.integers(0, 64, int(flat.sum())) / 63.0
    return torch.from_numpy(rows).to(device)


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


def textured(model, seed=7):
    """``model`` handed over by ``Model.from_state`` with a seeded colour a
    vertex (indexed like the vertices), as the benchmark's frame cells
    hand theirs over, so its frames gather the colours
    (``Model.colors_by_triangles``) instead of drawing fallback ones."""
    import numpy as np

    from cython3dmodelrenderer_tpu_torch import Model

    faces = model._faces_v.cpu().numpy()
    colors = np.random.RandomState(seed).uniform(
        0, 255, (model.n_vertices(), 3)).astype(np.float32)
    return Model.from_state(
        {"vertices": model.vertices.cpu().numpy(), "faces_v": faces,
         "normals": model.normals.cpu().numpy(),
         "faces_n": model._faces_n.cpu().numpy(), "colors": colors,
         "faces_vt": faces}, device=model.device)


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
    per (pair, pixel) of the pair's ceil bbox in its tile and the image;
    the winner's epilogue is left out, so this is a floor)."""
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


def sort_bound(keys, bits):
    """B2: keys read and written once; a digit extraction and a rank a key
    a pass (``ceil(bits / 8)`` passes)."""
    from cython3dmodelrenderer_tpu_torch.measure import roofline_ms

    return roofline_ms(2 * nbytes(keys), 2 * keys.numel() * -(-bits // 8))


def binning_bound(spans, outputs, pairs):
    """B4 / B5: spans read once, every output written once; a count and a
    placement per pair."""
    from cython3dmodelrenderer_tpu_torch.measure import roofline_ms

    return roofline_ms(nbytes(*spans[:4], *outputs), 2 * pairs)


def frontend_instructions(n_attrs, fast, posed):
    """F1's f32 instructions a (view, triangle), counted from
    csrc/frontend.cu: cull 12, projection 93, λ planes 42, z plane 15,
    bbox and its rule 46, spans 12; 15 an attribute channel; fast shade
    57; the pose 99."""
    return 220 + 15 * n_attrs + 57 * fast + 99 * posed


def frontend_bound(args, kwargs, outputs):
    """F1: vertices, normals, colours (with channels) and poses read once,
    rows, spans and the total written once; ``frontend_instructions`` a
    (view, triangle)."""
    from cython3dmodelrenderer_tpu_torch.measure import roofline_ms

    verts, norms, colors, _config, n_attrs = args[:5]
    poses = kwargs.get("poses")
    inputs = [verts, norms] + ([colors] if n_attrs else []) + (
        [poses] if poses is not None else [])
    ops = outputs[0].shape[0] * frontend_instructions(
        n_attrs, kwargs.get("shade") is not None, poses is not None)
    return roofline_ms(nbytes(*inputs, *outputs), ops)


def colors_bound(t):
    """csrc/colors.cu: 3 bytes a triangle read from pinned host memory
    over PCIe and 36 written to the card's memory; the slower of the
    two."""
    from cython3dmodelrenderer_tpu_torch.measure import HBM_BYTES_PER_S

    return (max(3 * t / PCIE_BYTES_PER_S, 36 * t / HBM_BYTES_PER_S) * 1e3,
            "bytes")


def pair_keys(spans):
    """The packed pair keys ``bin_pairs`` gives B2 for ``spans``, and their
    width in bits."""
    from cython3dmodelrenderer_tpu_torch.ops import binsort

    tx0, cx, ty0, cy, ntx, nty, total = spans
    tri_bits = binsort.key_bits(tx0.shape[0], ntx * nty)
    tri_p, tile_p = binsort.expand_pairs(tx0, cx, ty0, cy, ntx, total)
    return (tile_p << tri_bits) | tri_p, tri_bits + binsort.tile_bits(ntx * nty)


def frame_inputs(model, post):
    """The binned raster inputs a 1024² main-path frame of ``model`` gives
    kernel B1 (and its pair keys and their width, B2's input)."""
    from cython3dmodelrenderer_tpu_torch.ops import binsort
    from cython3dmodelrenderer_tpu_torch.ops.sort import sort_i32_plain

    kw, spans = frame_setup(model, post, SIZE)
    bins = binsort.bin_pairs(*spans, sort=sort_i32_plain)
    return with_bins(kw, bins), pair_keys(spans)


def check_keys(gen, n, width):
    """``n`` keys in [0, 2^width) with runs of duplicates, holding
    2^width - 1 (INT32_MAX at width 31) and 0."""
    import torch

    keys = torch.randint(0, 1 << width, (n,), generator=gen, device="cuda",
                         dtype=torch.int64)
    if n:
        keys[::7] = keys[0].clone()
    keys[1::11] = (1 << width) - 1
    keys[2::13] = 0
    return keys.to(torch.int32)


def same_bits(a, b):
    """Equal bit for bit (a float -0.0 differs from +0.0, NaN equals the
    same NaN)."""
    import torch

    if a.is_floating_point():
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def raster_opts(post, light):
    return dict(light=light if post == "lambert_u8" else None,
                gbuffer=post == "none", image=post != "none")


def check_raster(tag, kw, light, posts=POSTS):
    """B1 (``raster_tiles``) against its plain version on ``kw`` for each
    post: bit-equal in every output and equal to itself on a second call.
    Returns the largest |kernel - plain| (0.0 when all are equal)."""
    import torch

    from cython3dmodelrenderer_tpu_torch.ops.raster import (raster_tiles,
                                                            raster_tiles_plain)

    err = 0.0
    for post in posts:
        opts = raster_opts(post, light)
        runs = [raster_tiles(**kw, **opts), raster_tiles(**kw, **opts),
                raster_tiles_plain(**kw, **opts)]
        torch.cuda.synchronize()
        got, again, want = ([*g] if post == "none" else [i] for g, i in runs)
        for a, b, c in zip(got, again, want):
            err = max(err, max_abs_err(a.float(), c.float()))
            require(same_bits(a, c), f"B1 {tag} {post}: differs from the "
                    "plain version")
            require(same_bits(a, b), f"B1 {tag} {post}: two runs differ")
        say("kernels", f"B1 {tag} {post}: bit-equal to plain, equal to itself "
            f"on a second call ({int(kw['pair_tri'].numel())} pairs)")
    return err


def time_raster(kw, opts, n, n_plain):
    """B1 on ``kw``: CUDA-event ms a call of the wrapper and of the plain
    version, and the kernel's device ms and device operations a call
    (torch.profiler)."""
    from cython3dmodelrenderer_tpu_torch.measure import (cuda_time_ms,
                                                         profile_calls)
    from cython3dmodelrenderer_tpu_torch.ops.raster import (raster_tiles,
                                                            raster_tiles_plain)

    dev_ms, ops = profile_calls(lambda: raster_tiles(**kw, **opts), 20)
    return {"ms": cuda_time_ms(lambda: raster_tiles(**kw, **opts), n),
            "plain_ms": cuda_time_ms(lambda: raster_tiles_plain(**kw, **opts),
                                     n_plain),
            "device_ms": dev_ms, "device_ops": ops}


# ---------------------------------------------------------------------------
# F1: the front end
# ---------------------------------------------------------------------------

def frontend_edge_scene(device, n=600, seed=11):
    """``n`` seeded triangles reaching past the image edges, with colours
    and unit normals; rows 0-5 hold a vertex on the camera plane (w = 0),
    a NaN x coordinate, a degenerate, a backfacing, a fully off-screen and
    a huge clipped triangle."""
    import torch

    g = torch.Generator().manual_seed(seed)
    centers = (torch.rand((n, 1, 3), generator=g) - 0.5) * 1.3
    centers[..., 2] = 0.7 + 0.7 * torch.rand((n, 1), generator=g)
    tris = centers + (torch.rand((n, 3, 3), generator=g) - 0.5) * 0.5
    normals = torch.randn((n, 3, 3), generator=g)
    normals = normals / normals.norm(dim=-1, keepdim=True)
    colors = 255.0 * torch.rand((n, 3, 3), generator=g)
    tris[0, 1, 2] = 0.0
    tris[1, 2, 0] = float("nan")
    tris[2, 2] = tris[2, 0]
    normals[3, :, 2] = normals[3, :, 2].abs() + 0.1
    tris[4, :, 0] += 5.0
    tris[5] = torch.tensor([[-2.0, -2.0, 1.0], [3.0, -1.0, 1.0],
                            [0.0, 3.0, 1.0]])
    front = [0, 1, 2, 4, 5]
    normals[front, :, 2] = -normals[front, :, 2].abs() - 0.1
    return tuple(t.to(device) for t in (tris, normals, colors))


def frontend_call(verts, norms, colors, height, width, n_attrs, fast, light,
                  poses=None):
    """F1's positional and keyword arguments for a height x width frame."""
    from cython3dmodelrenderer_tpu_torch.config import RenderConfig
    from cython3dmodelrenderer_tpu_torch.ops import raster

    config = RenderConfig(height=height, width=width, fov=FOV)
    return ((verts, norms, colors, config, n_attrs, raster.TILE_H,
             raster.TILE_W), dict(shade=light if fast else None, poses=poses))


def sweep_poses(vb):
    """The (vb, 4, 3) poses of the sweep's first vb views."""
    import torch

    from cython3dmodelrenderer_tpu_torch.parallel import multiview

    return torch.stack([multiview._pose_matrix(a, s) for a, s in
                        zip(sweep_angles()[:vb], sweep_shifts()[:vb])])


def check_frontend(tag, args, kwargs):
    """F1 (``frame_planes``) against its plain version on the card: every
    output bit for bit, NaN bits included, and equal to itself on a second
    call (so F1's ``max_abs_err`` is 0.0)."""
    import torch

    from cython3dmodelrenderer_tpu_torch.ops.frontend import (
        frame_planes, frame_planes_plain)

    runs = [frame_planes(*args, **kwargs), frame_planes(*args, **kwargs),
            frame_planes_plain(*args, **kwargs)]
    torch.cuda.synchronize()
    for name, got, again, want in zip(FRONTEND_OUTPUTS, *runs):
        if not same_bits(got, want):
            detail = f"{tuple(got.shape)} against {tuple(want.shape)}"
            if got.is_floating_point() and got.shape == want.shape:
                differ = got.view(torch.int32) != want.view(torch.int32)
                nan = differ & torch.isnan(got) & torch.isnan(want)
                detail = (f"{int(differ.sum())} of {got.numel()} differ, "
                          f"{int(nan.sum())} of them NaN against NaN")
            elif got.shape == want.shape:
                detail = f"{int((got != want).sum())} of {got.numel()} differ"
            raise SmokeFailure(f"F1 {tag}: {name} differs from the plain "
                               f"version ({detail})")
        require(same_bits(got, again), f"F1 {tag}: {name}: two runs differ")
    rows = runs[0][0]
    say("kernels", f"F1 {tag}: bit-equal to plain, equal to itself on a "
        f"second call ({rows.shape[0]} rows x {rows.shape[1]}, "
        f"{int(runs[0][-1])} pairs)")


def time_frontend(tag, args, kwargs):
    """F1 against its plain version: CUDA-event ms a call of each, device
    ms and device operations a call of each (torch.profiler), and F1's
    bound on these inputs and the share of it the kernel reaches. F1 is
    one device operation a call (two for posed views made on the host:
    the poses' copy)."""
    from cython3dmodelrenderer_tpu_torch.measure import (cuda_time_ms,
                                                         profile_calls)
    from cython3dmodelrenderer_tpu_torch.ops.frontend import (
        frame_planes, frame_planes_plain)

    def kernel():
        return frame_planes(*args, **kwargs)

    def plain():
        return frame_planes_plain(*args, **kwargs)

    # a profiler session now and then loses some of the calls' device
    # events (0.65 or 1.95 operations a call, or none at all): take the
    # first session that recorded a whole number of operations a call
    for _ in range(5):
        dev_ms, ops = profile_calls(kernel, 20)
        if ops is not None and float(ops).is_integer():
            break
    plain_dev_ms, plain_ops = profile_calls(plain, 10)
    out = {"ms": cuda_time_ms(kernel, 100), "plain_ms": cuda_time_ms(plain, 20),
           "device_ms": dev_ms, "device_ops": ops,
           "plain_device_ms": plain_dev_ms, "plain_device_ops": plain_ops}
    out["bound"] = frontend_bound(args, kwargs, kernel())
    want_ops = 1 + (kwargs.get("poses") is not None
                    and kwargs["poses"].device.type == "cpu")
    require(ops == want_ops, f"F1 {tag}: {ops} device operations a call, "
            f"not {want_ops}")
    out["bound_fraction"] = out["bound"][0] / dev_ms
    say("timing", f"F1 {tag}: kernel {out['ms']:.4f} ms a call (CUDA events),"
        f" device {dev_ms} ms in {ops} device operations (want {want_ops}); "
        f"plain chain {out['plain_ms']:.4f} ms, device {plain_dev_ms} ms in "
        f"{plain_ops} operations; bound {out['bound'][0]:.6f} ms "
        f"({out['bound'][1]}), {out['bound_fraction']:.4f} of it by device ms")
    return out


def phase_kernels_frontend(scenes, light):
    """F1 against its plain version: every scene at SIZE², the edge scene
    at FRONTEND_EDGE_FRAMES, posed in three views, cut to the triangle
    counts around a block (FRONTEND_COUNTS) and posed in three views at
    T = 45 and 200 (blocks across view boundaries), and no triangles,
    each in every variant (0, 3, 6 channels, fast shade); the built
    kernel's launch constants against the wrapper's plan."""
    import torch

    from cython3dmodelrenderer_tpu_torch.ops import frontend

    for n_attrs in (0, 3, 6):
        got = frontend.kernel_constants(n_attrs)
        plan = frontend.frontend_plan(16128, n_attrs)
        require(got["threads"] == plan.threads
                and got["smem_bytes"] == plan.smem_bytes,
                f"F1 C={n_attrs}: built constants {got} against the plan "
                f"{plan}")
        say("kernels", f"F1 C={n_attrs}: {got['threads']} threads a block, "
            f"{got['smem_bytes']} bytes of shared memory, "
            f"{got['registers']} registers and {got['local_bytes']} local "
            f"(spilled) bytes a thread; sphere16k's 16,128 triangles in "
            f"{plan.blocks} blocks")
    edge = frontend_edge_scene("cuda")
    empty = tuple(torch.zeros((0, 3, 3), device="cuda") for _ in range(3))
    cases = [(f"{name}@{SIZE}", (model.vertices_by_triangles,
                                 model.normals_by_triangles,
                                 seeded_colors(model)), SIZE, SIZE, None)
             for name, model in scenes.items()]
    cases += [(f"edge@{h}x{w}", edge, h, w, None)
              for h, w in FRONTEND_EDGE_FRAMES]
    cases += [(f"edge posed x3 @{SIZE}", edge, SIZE, SIZE, sweep_poses(3)),
              (f"empty@{SIZE}", empty, SIZE, SIZE, None)]
    cases += [(f"edge[:{t}]@{SIZE}", tuple(a[:t] for a in edge), SIZE, SIZE,
               None) for t in FRONTEND_COUNTS]
    cases += [(f"edge[:{t}] posed x3 @{SIZE}", tuple(a[:t] for a in edge),
               SIZE, SIZE, sweep_poses(3)) for t in (45, 200)]
    for tag, arrays, h, w, poses in cases:
        for vtag, n_attrs, fast in FRONTEND_VARIANTS:
            args, kw = frontend_call(*arrays, h, w, n_attrs, fast, light,
                                     poses)
            check_frontend(f"{tag} {vtag}", args, kw)


def phase_kernels_colors():
    """The fallback colours' expansion (``ops/colors.py::vertex_colors``,
    csrc/colors.cu) against ``vertex_colors_plain`` on the same pinned
    bytes copied to the card: bit for bit, on the current stream and on a
    stream given; then CUDA-event ms of each at ``COLORS_TIMED``."""
    import torch

    from cython3dmodelrenderer_tpu_torch.measure import cuda_time_ms
    from cython3dmodelrenderer_tpu_torch.ops.colors import (
        vertex_colors, vertex_colors_plain)

    dev = torch.device(DEVICE)
    stream = torch.cuda.current_stream(dev)
    pinned = {}
    for t in COLORS_CHECK_SIZES:
        per_tri = torch.randint(256, (t, 3), dtype=torch.uint8,
                                generator=torch.Generator().manual_seed(t))
        per_tri = per_tri.pin_memory()
        want = vertex_colors_plain(per_tri.to(dev))
        for got in (vertex_colors(per_tri, dev),
                    vertex_colors(per_tri, dev, stream)):
            require(got.dtype == torch.float32 and torch.equal(got, want),
                    f"vertex_colors T={t}: != vertex_colors_plain")
        pinned[t] = per_tri
    say("kernels", "vertex_colors (csrc/colors.cu) == vertex_colors_plain "
        f"bit for bit at T = {', '.join(map(str, COLORS_CHECK_SIZES))}")
    times = {}
    for tag, t in COLORS_TIMED:
        per_tri = pinned[t]
        ms = cuda_time_ms(lambda: vertex_colors(per_tri, dev, stream), 100)
        plain = cuda_time_ms(lambda: vertex_colors_plain(
            per_tri.to(dev, non_blocking=True)), 100)
        times[tag] = {"ms": ms, "plain_ms": plain, "bound": colors_bound(t)}
        say("kernels", f"vertex_colors {tag} ({t} triangles): kernel "
            f"{ms:.4f} ms, plain {plain:.4f} ms, bound "
            f"{times[tag]['bound'][0]:.4f} ms")
    return times


def phase_kernels(scenes, light):
    import torch

    from cython3dmodelrenderer_tpu_torch.ops.sort import sort_i32, sort_i32_plain

    gen = torch.Generator(device="cuda").manual_seed(0)
    sort_err = 0
    for n in SORT_CHECK_SIZES:
        for width, bits in SORT_CHECK_WIDTHS:
            keys = check_keys(gen, n, width)
            got, again = sort_i32(keys, bits), sort_i32(keys, bits)
            want = sort_i32_plain(keys)
            torch.cuda.synchronize()
            require(torch.equal(got, want),
                    f"B2 sort disagrees at n={n}, width {width}, bits {bits}")
            require(torch.equal(got, again),
                    f"B2 sort: two runs differ at n={n}, bits {bits}")
            if n:
                sort_err = max(sort_err, int((got - want).abs().max()))
    say("kernels", f"B2 sort == torch.sort, deterministic, at n = "
        f"{SORT_CHECK_SIZES} x (key width, bits) {SORT_CHECK_WIDTHS}")
    for n in (17473, 200000):                  # one hot bucket every pass
        keys = torch.full((n,), (1 << 31) - 1, dtype=torch.int32,
                          device="cuda")
        require(torch.equal(sort_i32(keys, 31), keys),
                f"B2 sort: {n} equal keys come back changed")
    say("kernels", "B2 sort: 17,473 and 200,000 equal keys unchanged")

    raster_err = 0.0
    inputs = {}
    for name, model in scenes.items():
        for post in POSTS:
            kw, (keys, bits) = frame_inputs(model, post)
            inputs.setdefault(name, {})[post] = (kw, (keys, bits))
            if post == "lambert_u8":
                got = sort_i32(keys, bits)
                require(torch.equal(got, sort_i32_plain(keys)),
                        f"B2 sort disagrees on {name}'s {keys.numel()} pair "
                        f"keys at {bits} bits")
                say("kernels", f"B2 sort {name}: {keys.numel()} pair keys at "
                    f"{bits} bits == torch.sort")
            raster_err = max(raster_err, check_raster(f"{name}@{SIZE}", kw,
                                                      light, (post,)))
    for seed in MERGE_SEEDS:         # ties, -0.0, NaN rows, an 80-wide frame
        raster_err = max(raster_err, check_raster(
            f"merge case {seed} (40 x 80)", merge_case("cuda", 1, seed), light))
    return sort_err, raster_err, inputs


def synthetic_spans(n_tris, ntx, nty, n_live):
    """Spans of ``n_tris`` triangles of which the first ``n_live`` (0 or 1)
    cover one tile each, the rest culled: 0 and 1 pairs."""
    import torch

    zeros = torch.zeros(n_tris, dtype=torch.int32, device="cuda")
    live = (torch.arange(n_tris, device="cuda") < n_live).to(torch.int32)
    return (live * (ntx // 2), live, live * (nty // 3), live, ntx, nty, n_live)


def one_tile_spans(n_tris, ntx, nty, device="cuda"):
    """Spans of ``n_tris`` triangles that all cover the one tile
    (ntx // 2, nty // 3): one hot digit bucket in every radix pass."""
    import torch

    ones = torch.ones(n_tris, dtype=torch.int32, device=device)
    return (ones * (ntx // 2), ones, ones * (nty // 3), ones, ntx, nty, n_tris)


def phase_kernels_large(scenes, light):
    """B4 against its plain version at the un-grouped frames' spans, and
    B1 on B4's bins (the B3 route) against the plain raster."""
    import torch

    from cython3dmodelrenderer_tpu_torch.ops.binsort import (bin_sort,
                                                             bin_sort_plain)

    cases = [(f"{name}@{size}", frame_setup(scenes[name], "lambert_u8", size)[1])
             for name, size in LARGE_FRAMES]
    cases += [(f"{n} pair", synthetic_spans(4096, 32, 64, n)) for n in (0, 1)]
    cases += [(f"one tile x {n}", one_tile_spans(n, 32, 64))
              for n in ONE_TILE_TRIS]
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
        for post in POSTS:
            kw, spans = frame_setup(scenes[name], post, size)
            kw = with_bins(kw, bin_sort(*spans))
            inputs[(name, size, post)] = kw
            b3_err = max(b3_err, check_raster(f"on B4 bins (B3 route) "
                                              f"{name}@{size}", kw, light,
                                              (post,)))
    for n in ONE_TILE_TRIS:          # one block walks the whole bin
        spans = one_tile_spans(n, 32, 64)
        kw = with_bins(dict(rows=one_tile_rows(n, 32, 64, "cuda"), ntx=32,
                            nty=64, height=1024, width=1024, n_attrs=6,
                            z_init=1e6), bin_sort(*spans))
        b3_err = max(b3_err, check_raster(f"on B4 bins, one tile x {n}", kw,
                                          light, ("none", "lambert_u8")))
    for name, size in LARGE_FRAMES:
        model = scenes[name]
        for vtag, n_attrs, fast in FRONTEND_VARIANTS:
            args, kw = frontend_call(model.vertices_by_triangles,
                                     model.normals_by_triangles,
                                     seeded_colors(model), size, size, n_attrs,
                                     fast, light)
            check_frontend(f"{name}@{size} {vtag}", args, kw)
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

    illums = (("guro", GuroIllumination([0, 0, 1])), ("none", NoIllumination()))
    before = launch_counts("raster", "binsort", "sort", "frontend", "colors",
                           "reruns")
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
    launches = launches_since(before)
    # each render of an untextured model draws its colours once; the
    # no-device render is of igor_sphere
    untextured = (sum(2 for name, _illum in results
                      if not scenes[name].has_colors)
                  + (not scenes["igor_sphere"].has_colors))

    plain_before = launch_counts("colors")
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
    require(launches_since(plain_before)["colors"] == 0,
            "the plain-version frames launched csrc/colors.cu")
    say("main", f"Renderer, filler and Model.read_model with no device: on "
        f"{img.device}, backend {renderer.pixel_buffer_filler.backend}, "
        "== the igor_sphere guro frame")
    require(launches["raster"] > 0 and launches["binsort"] > 0
            and launches["sort"] == 0 and launches["frontend"] > 0,
            f"not F1, B4 + B1 alone on the main path: {launches}")
    # every frame (the lazy z getter's re-render too) runs F1 once, B1 once
    # and once more when it overflowed B4's capacity
    require(launches["frontend"] + launches["reruns"] == launches["raster"],
            f"F1 was not launched once a frame: {launches}")
    require(untextured > 0 and launches["colors"] == untextured,
            f"csrc/colors.cu was not launched once an untextured frame "
            f"({untextured} frames): {launches}")
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
    from cython3dmodelrenderer_tpu_torch.ops.projection import (
        project_to_screen, visibility_masks)
    from cython3dmodelrenderer_tpu_torch.ops.raster import (rasterize,
                                                            render_frame)

    illums = (("guro", GuroIllumination([0, 0, 1])), ("none", NoIllumination()))
    model = scenes["torus262k"]
    config = RenderConfig(height=SIZE, width=SIZE, fov=FOV)
    tv, tn = model.vertices_by_triangles, model.normals_by_triangles
    tc = seeded_colors(model)
    deg, back = visibility_masks(tv, tn)
    screen = project_to_screen(tv, config)
    before = launch_counts("binsort", "raster", "sort", "frontend", "reruns")
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
    launches = launches_since(before)

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
    # F1 once a frame (B1 once more on a re-run); rasterize() takes
    # projected input and skips F1
    require(launches["frontend"] + launches["reruns"]
            == launches["raster"] - 1 > 0,
            f"F1 was not launched once a frame: {launches}")
    say("large", f"kernel launches on the un-grouped path: {launches}")
    return launches, results


def read_first_frame(tv, tn, tc, config, light):
    """The lit frame in the order frames took before B4 took its total from
    the card: F1, the host read of its pair total, B4 sized exactly, B1.
    Returns (image, pairs)."""
    from cython3dmodelrenderer_tpu_torch.ops import binsort, frontend, raster

    rows, tx0, cx, ty0, cy, _counts, total = frontend.frame_planes(
        tv, tn, tc, config, 6, raster.TILE_H, raster.TILE_W)
    total = int(total)
    ntx, nty = SIZE // raster.TILE_W, SIZE // raster.TILE_H
    bins = binsort.bin_sort(tx0, cx, ty0, cy, ntx, nty, total)
    _g, img = raster.raster_tiles(rows, *bins, ntx, nty, SIZE, SIZE, 6,
                                  config.z_init, light=light, gbuffer=False,
                                  image=True)
    return img, total


def phase_capacity(light, smi):
    """B4 sized from a capacity, the pair total read after B1's launch
    (``raster.frame_stages``): a Dragon-sized 16-pose sequence through the
    filler from capacity 0 re-runs where a pose's total passes the
    capacity, and every image equals the read-first frame's bit for bit;
    a second pass over the poses only fits. Then host-clock ms a frame of
    both orders through the same glue (``raster.render_frame`` against
    ``read_first_frame``, neither with the filler's statistics), in turns,
    each frame synchronised on its image."""
    import numpy as np
    import torch

    from cython3dmodelrenderer_tpu_torch import (AdvancedPixelBufferFiller,
                                                 Model)
    from cython3dmodelrenderer_tpu_torch.config import RenderConfig
    from cython3dmodelrenderer_tpu_torch.ops import raster
    from cython3dmodelrenderer_tpu_torch.parallel import multiview
    from cython3dmodelrenderer_tpu_torch.utils.timing import counters

    t0 = time.perf_counter()
    v, f = displaced_torus(*CAPACITY_TORUS)
    model = Model(v, f, device=DEVICE)
    tri, nrm = model.vertices_by_triangles, model.normals_by_triangles
    rng = np.random.RandomState(5)
    angles = (360.0 * np.arange(CAPACITY_POSES) / CAPACITY_POSES
              + rng.uniform(-11.25, 11.25, CAPACITY_POSES))
    poses = [tuple(t.contiguous() for t in multiview._pose_triangles(
        tri, nrm, [CAPACITY_TILT, a, 0.0], CAPACITY_SHIFT)) for a in angles]
    tc = torch.from_numpy(rng.uniform(0, 255, f.shape[:1] + (3, 3))
                          .astype(np.float32)).to(DEVICE)
    config = RenderConfig(height=SIZE, width=SIZE, fov=FOV)
    filler = AdvancedPixelBufferFiller(SIZE, SIZE, fov=FOV, device=DEVICE,
                                       backend="cuda")
    key = raster._capacity_key(torch.device(DEVICE, torch.cuda.current_device()),
                               SIZE // raster.TILE_W, SIZE // raster.TILE_H)
    raster._CAPACITY.pop(key, None)
    say("capacity", f"{tri.shape[0]} triangles in {CAPACITY_POSES} poses, "
        f"built in {time.perf_counter() - t0:.1f} s; capacity 0")

    def counted():
        return (counters["bins_capacity_fits"],
                counters["bins_capacity_reruns"])

    want, passes = [], []
    for p in range(2):
        start, caps, reruns = counted(), [], []
        for k, (tv, tn) in enumerate(poses):
            before = counted()[1]
            filler.render_arrays(tv, tn, tc, post="lambert_u8", light=light)
            img = filler.get_post_image()
            reruns.append(counted()[1] - before)
            caps.append(raster._CAPACITY[key])
            if p == 0:
                want.append(read_first_frame(tv, tn, tc, config, light))
            ref, pairs = want[k]
            require(torch.equal(img, ref),
                    f"capacity pass {p} pose {k}: image != the read-first "
                    f"frame's ({float((img != ref).any(-1).float().mean())} "
                    "of pixels)")
            stats = filler.get_render_stats()
            require(stats["pairs"] == filler.last_pairs == pairs
                    and filler.validate_capacity()
                    and not filler.frame_provisional,
                    f"capacity pass {p} pose {k}: stats {stats}, {pairs} pairs")
            require(caps[-1] >= max(w[1] for w in want[:k + 1])
                    and caps[-1] % 2048 == 0
                    and (k == 0 or caps[-1] >= caps[-2]),
                    f"capacity pass {p} pose {k}: capacity {caps}")
        fits, rerun = (a - b for a, b in zip(counted(), start))
        require(fits + rerun == CAPACITY_POSES and (rerun > 0) == (p == 0),
                f"capacity pass {p}: {fits} fits, {rerun} re-runs")
        passes.append({"fits": fits, "reruns": rerun,
                       "rerun_poses": [k for k, r in enumerate(reruns) if r],
                       "capacity": caps[-1]})
        say("capacity", f"pass {p}: {fits} fits, {rerun} re-runs (poses "
            f"{passes[-1]['rerun_poses']}), capacity {caps[0]} -> {caps[-1]}, "
            f"pairs {min(w[1] for w in want)}-{max(w[1] for w in want)}; "
            "every image == the read-first frame")

    def timed(frame):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(CAPACITY_PASSES):
            for tv, tn in poses:
                torch.cuda.synchronize(frame(tv, tn))
        return (time.perf_counter() - t) / len(poses) / CAPACITY_PASSES * 1e3

    def capacity_frame(tv, tn):         # the frame's glue, as read_first's
        return raster.render_frame(tv, tn, tc, config, post="lambert_u8",
                                   light=light, backend="cuda")[1].device

    def read_first(tv, tn):
        return read_first_frame(tv, tn, tc, config, light)[0].device

    ms = {"capacity": [], "read_first": []}
    fits, reruns = counted()
    for _ in range(CAPACITY_ROUNDS):
        ms["read_first"].append(timed(read_first))
        ms["capacity"].append(timed(capacity_frame))
    require(counted() == (fits + CAPACITY_ROUNDS * CAPACITY_PASSES
                          * CAPACITY_POSES, reruns),
            f"capacity: the timed frames re-ran ({counted()}, from "
            f"{(fits, reruns)})")
    med = {k: sorted(x)[len(x) // 2] for k, x in ms.items()}
    say("capacity", f"ms a frame, host clock, {CAPACITY_PASSES} x "
        f"{CAPACITY_POSES} poses a round, "
        f"{CAPACITY_ROUNDS} rounds in turns: read-first {ms['read_first']} "
        f"(median {med['read_first']:.4f}), capacity {ms['capacity']} "
        f"(median {med['capacity']:.4f}); {smi}")
    return {"passes": passes, "ms": ms, "median_ms": med,
            "pairs": [w[1] for w in want], "card": smi}


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
    frame_ms = {}
    for (name, iname), (renderer, *_rest) in results.items():
        frame_ms[f"{name}/{iname}"] = time_frames(f"{name} {iname}", renderer,
                                                  scenes[name], WARM_FRAMES)
    # the kernels at the main path's shapes: the 16k-triangle sphere's frame
    kw, (keys, bits) = inputs["sphere16k"]["lambert_u8"]
    sort_ms = time_sort("sphere16k@1024 pair keys", keys, bits)
    frame_ms["sort_sphere16k@1024"] = sort_ms
    b1 = time_raster(kw, raster_opts("lambert_u8", light), 100, 20)
    frame_ms["raster_sphere16k@1024"] = b1
    kt = {"sort": (sort_ms["b2"]["ms"], sort_ms["torch_sort"]["ms"]),
          "raster": (b1["ms"], b1["plain_ms"])}
    for k, (ms, plain) in kt.items():
        say("timing", f"{k}: kernel {ms:.4f} ms, plain {plain:.4f} ms "
            f"(sphere16k lambert_u8 frame: {keys.numel()} pair keys)")
    say("timing", f"B1 sphere16k@{SIZE}: device {b1['device_ms']} ms in "
        f"{b1['device_ops']} device operations a call")
    bounds = {"sort": sort_bound(keys, bits), "raster": raster_bound(kw)}
    model = scenes["sphere16k"]
    for n_attrs in (6, 3):           # the Guro frame's rows, then the None's
        frame_ms[f"frontend_sphere16k@{SIZE}_c{n_attrs}"] = time_frontend(
            f"sphere16k@{SIZE} C={n_attrs}", *frontend_call(
                model.vertices_by_triangles, model.normals_by_triangles,
                seeded_colors(model), SIZE, SIZE, n_attrs, False, light))
    return frame_ms, kt, bounds


def time_sort(tag, keys, bits):
    """B2 beside torch.sort on ``keys``: CUDA-event ms a call (both) and
    device ms and device operations a call (torch.profiler)."""
    from cython3dmodelrenderer_tpu_torch.measure import (cuda_time_ms,
                                                         profile_calls)
    from cython3dmodelrenderer_tpu_torch.ops import sort

    out = {}
    for name, fn in (("b2", lambda: sort.sort_i32(keys, bits)),
                     ("torch_sort", lambda: sort.sort_i32_plain(keys))):
        dev_ms, ops = profile_calls(fn, 20)
        out[name] = {"ms": cuda_time_ms(fn, 100), "device_ms": dev_ms,
                     "device_ops": ops}
    plan = sort.plan(keys.numel(), bits)
    say("timing", f"B2 {tag} ({keys.numel()} keys, {bits} bits, "
        f"{plan.passes} passes, {'one launch' if plan.one_launch else 'onesweep'}"
        f"): {out['b2']['ms']:.4f} ms a call (CUDA events), device "
        f"{out['b2']['device_ms']} ms in {out['b2']['device_ops']} device "
        f"operations; torch.sort {out['torch_sort']['ms']:.4f} ms, device "
        f"{out['torch_sort']['device_ms']} ms in "
        f"{out['torch_sort']['device_ops']} operations")
    return out


def phase_timing_large(scenes, results, inputs, light):
    """The un-grouped frames; B4 and the B3 route against their plain
    versions at torus262k@1024; both routes' binning at sphere16k@1024."""
    from cython3dmodelrenderer_tpu_torch.measure import (cuda_time_ms,
                                                         profile_calls)
    from cython3dmodelrenderer_tpu_torch.ops.binsort import bin_pairs, bin_sort
    from cython3dmodelrenderer_tpu_torch.ops.sort import sort_i32

    frame_ms = {}
    for (name, size, iname), (renderer, *_rest) in results.items():
        frame_ms[f"{name}@{size}/{iname}"] = time_frames(
            f"{name}@{size} {iname}", renderer, scenes[name], LARGE_WARM_FRAMES)
    for name, size in LARGE_FRAMES[1:]:                # torus262k@1024, @4096
        spans = frame_setup(scenes[name], "lambert_u8", size)[1]
        frame_ms[f"bin_sort_{name}@{size}"] = time_bin_sort(f"{name}@{size}",
                                                            spans)
    name, size = LARGE_FRAMES[1]                       # torus262k@1024
    spans = frame_setup(scenes[name], "lambert_u8", size)[1]
    kw = inputs[(name, size, "lambert_u8")]
    bounds = {"binsort": binning_bound(spans, bin_sort(*spans), spans[-1]),
              "b3_route": raster_bound(kw)}
    b4 = frame_ms[f"bin_sort_{name}@{size}"]
    b3 = time_raster(kw, raster_opts("lambert_u8", light), 50, 10)
    frame_ms[f"raster_b3_route_{name}@{size}"] = b3
    kt = {"binsort": (b4["ms"], b4["plain_ms"]),
          "b3_route": (b3["ms"], b3["plain_ms"])}
    for k, (ms, plain) in kt.items():
        say("timing", f"{k}: kernel {ms:.4f} ms, plain {plain:.4f} ms "
            f"({name}@{size} lambert_u8: {spans[-1]} pairs)")
    say("timing", f"B3 route {name}@{size}: device {b3['device_ms']} ms in "
        f"{b3['device_ops']} device operations a call")
    small = frame_setup(scenes["sphere16k"], "lambert_u8", SIZE)[1]
    routes = {"counting_sort": lambda: bin_sort(*small),
              "sort_searchsorted": lambda: bin_pairs(*small, sort=sort_i32)}
    out = {}
    for route, fn in routes.items():
        dev_ms, ops = profile_calls(fn, 20)
        out[route] = {"ms": cuda_time_ms(fn, 100), "device_ms": dev_ms,
                      "device_ops": ops}
    say("timing", f"binning sphere16k@{SIZE} ({small[-1]} pairs): counting-sort "
        f"route (B4) {out['counting_sort']['ms']:.4f} ms, device "
        f"{out['counting_sort']['device_ms']} ms in "
        f"{out['counting_sort']['device_ops']} device operations; sort route "
        f"(B2 + searchsorted) {out['sort_searchsorted']['ms']:.4f} ms, device "
        f"{out['sort_searchsorted']['device_ms']} ms in "
        f"{out['sort_searchsorted']['device_ops']} operations")
    frame_ms[f"binning_routes_sphere16k@{SIZE}"] = out
    torus = scenes["torus262k"]
    for n_attrs in (6, 3):
        frame_ms[f"frontend_torus262k@{SIZE}_c{n_attrs}"] = time_frontend(
            f"torus262k@{SIZE} C={n_attrs}", *frontend_call(
                torus.vertices_by_triangles, torus.normals_by_triangles,
                seeded_colors(torus), SIZE, SIZE, n_attrs, False, light))
    return frame_ms, kt, bounds


def time_bin_sort(tag, spans):
    """B4's whole wrapper against its plain version (CUDA-event ms a call),
    its device ms and device operations a call (torch.profiler), and, on
    an earlier line, torch.sort of the same pairs' tile ids alone."""
    import torch

    from cython3dmodelrenderer_tpu_torch.measure import (cuda_time_ms,
                                                         profile_calls)
    from cython3dmodelrenderer_tpu_torch.ops import binsort

    _tri_p, tile_p = binsort.expand_pairs(*spans[:4], spans[4], spans[6])
    sort_ms = cuda_time_ms(lambda: torch.sort(tile_p, stable=True), 50)
    say("timing", f"yardstick {tag}: torch.sort(tile_p, stable=True) of its "
        f"{spans[-1]} pairs' tile ids alone {sort_ms:.4f} ms")
    dev_ms, ops = profile_calls(lambda: binsort.bin_sort(*spans), 20)
    out = {"ms": cuda_time_ms(lambda: binsort.bin_sort(*spans), 50),
           "plain_ms": cuda_time_ms(lambda: binsort.bin_sort_plain(*spans), 20),
           "device_ms": dev_ms, "device_ops": ops,
           "planned_ops": binsort.bin_sort_plan(spans[0].shape[0],
                                                spans[4] * spans[5],
                                                spans[6]).launches,
           "torch_sort_tile_ids_ms": sort_ms}
    say("timing", f"B4 bin_sort {tag} ({spans[-1]} pairs, {spans[4] * spans[5]}"
        f" tiles): whole wrapper {out['ms']:.4f} ms a call (CUDA events), "
        f"plain {out['plain_ms']:.4f} ms; device {dev_ms} ms in {ops} device "
        f"operations a call (planned {out['planned_ops']})")
    return out


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
    from cython3dmodelrenderer_tpu_torch.ops.raster import render_frame
    from cython3dmodelrenderer_tpu_torch.parallel import multiview

    illums = (("guro", GuroIllumination([0, 0, 1])), ("none", NoIllumination()))
    runs = [(iname, vb, False) for iname, _ in illums for vb in SWEEP_BATCHES]
    runs += [("guro", vb, True) for vb in FAST_BATCHES]
    renderers = {iname: make_renderer(illum) for iname, illum in illums}
    kernels = ("raster", "sort", "binsort", "frontend")
    results, per_sweep = {}, {}
    for iname, vb, fast in runs:    # warm: B4's capacity holds every batch
        renderers[iname].render_sequence(
            **sweep_args(renderers[iname], model, vb, fast))
    start = launch_counts(*kernels)
    for iname, vb, fast in runs:                    # the sweep path's run
        before = launch_counts(*kernels)
        results[(iname, vb, fast)] = renderers[iname].render_sequence(
            **sweep_args(renderers[iname], model, vb, fast))
        per_sweep[(iname, vb, fast)] = list(launches_since(before).values())
    torch.cuda.synchronize()
    launches = dict(launches_since(start),
                    raster_batched=sum(n[0] for (_i, vb, _f), n in
                                      per_sweep.items() if vb > 1),
                    frontend_batched=sum(n[3] for (_i, vb, _f), n in
                                         per_sweep.items() if vb > 1))

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
        n_b1, n_b2, n_b4, n_f1 = per_sweep[(iname, vb, fast)]
        require(n_b1 == SWEEP_VIEWS // vb,
                f"sweep {tag}: B1 launched {n_b1} times, not N/V")
        require(n_f1 == SWEEP_VIEWS // vb,
                f"sweep {tag}: F1 launched {n_f1} times, not once a batch")
        want_route = (0, SWEEP_VIEWS // vb)
        require((n_b2, n_b4) == want_route,
                f"sweep {tag}: B2/B4 launches {(n_b2, n_b4)}, want {want_route}")
        lit = float((imgs.amax(-1) > 0).float().mean())
        require(lit > 0.05, f"sweep {tag}: frames are empty ({lit})")
        say("sweep", f"{tag}: == view_batch=1, B1 x{n_b1}, B2 x{n_b2}, "
            f"B4 x{n_b4}, F1 x{n_f1}, {lit:.4f} of pixels lit")
    for iname, fast in (("guro", False), ("none", False), ("guro", True)):
        post = ("fast_lambert_u8" if fast else
                "lambert_u8" if iname == "guro" else "u8")
        for v, (pv, pn) in enumerate(posed):
            img = render_frame(pv, pn, colors, config, post=post,
                               light=light if iname == "guro" else None,
                               backend="cuda")[1]
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
    require(launches["raster_batched"] > 0 and launches["sort"] == 0
            and launches["binsort"] > 0 and launches["frontend_batched"] > 0,
            f"not F1, B4 + B1 alone on the sweep path: {launches}")
    say("sweep", f"kernel launches on the sweep path: {launches}")
    return launches, renderers, colors


def sweep_batch_planes(model, colors, post, vb):
    """The stacked plane rows of a view_batch=vb sweep batch and its spans
    on the ntx x vb·nty stacked grid (bin_sort's input)."""
    from cython3dmodelrenderer_tpu_torch.config import RenderConfig
    from cython3dmodelrenderer_tpu_torch.ops import raster
    from cython3dmodelrenderer_tpu_torch.parallel import multiview

    config = RenderConfig(height=SIZE, width=SIZE, fov=FOV)
    rows, tx0, cx, ty0, cy, _counts, total = multiview._stacked_planes(
        model.vertices_by_triangles, model.normals_by_triangles, colors,
        sweep_angles()[:vb], sweep_shifts()[:vb], config,
        3 if post == "u8" else 6)
    ntx, nty = SIZE // raster.TILE_W, SIZE // raster.TILE_H
    return rows, (tx0, cx, ty0, cy, ntx, vb * nty, int(total))


def sweep_batch_inputs(model, colors, post, vb=2):
    """The stacked rows and bins B1 gets from a view_batch=vb sweep batch."""
    from cython3dmodelrenderer_tpu_torch.config import RenderConfig
    from cython3dmodelrenderer_tpu_torch.ops import raster

    config = RenderConfig(height=SIZE, width=SIZE, fov=FOV)
    rows, (tx0, cx, ty0, cy, ntx, _stacked_nty, total) = sweep_batch_planes(
        model, colors, post, vb)
    nty = SIZE // raster.TILE_H
    bins = raster.route_bins(tx0, cx, ty0, cy, ntx, nty, total, "cuda", vb)
    kw = dict(rows=rows, ntx=ntx, nty=nty, height=SIZE, width=SIZE,
              n_attrs=3 if post == "u8" else 6, z_init=config.z_init,
              n_views=vb)
    return with_bins(kw, bins)


def phase_kernels_sweep(model, colors, light):
    """B1's view-batched launch against its plain version (view_batch 2);
    F1's posed batches of the sweep (view_batch 4 and 8, every variant)
    against its plain version. Returns B1's largest difference."""
    err = 0.0
    for post in POSTS:
        err = max(err, check_raster("view-batched (2 views) sphere16k",
                                    sweep_batch_inputs(model, colors, post),
                                    light, (post,)))
    err = max(err, check_raster("view-batched merge case (2 views, 40 x 80)",
                                merge_case("cuda", 2, 2), light))
    for vb in (4, SWEEP_VIEWS):
        for vtag, n_attrs, fast in FRONTEND_VARIANTS:
            args, kw = frontend_call(model.vertices_by_triangles,
                                     model.normals_by_triangles, colors, SIZE,
                                     SIZE, n_attrs, fast, light, sweep_poses(vb))
            check_frontend(f"sweep batch x{vb} {vtag}", args, kw)
    return err


def phase_timing_sweep(renderers, model, colors, light, frame_ms):
    """ms per view of each sweep (CUDA events over the sweep / N) beside
    the single-frame ms/frame, and B1 view-batched against its plain
    version at view_batch 2."""
    from cython3dmodelrenderer_tpu_torch.measure import cuda_time_ms

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
    keys, bits = pair_keys(sweep_batch_planes(model, colors, "lambert_u8", 4)[1])
    out["sort_vb4"] = time_sort("view_batch=4 batch pair keys", keys, bits)
    out["frontend_vb4"] = time_frontend("sweep batch x4 C=6", *frontend_call(
        model.vertices_by_triangles, model.normals_by_triangles, colors, SIZE,
        SIZE, 6, False, light, sweep_poses(4)))
    kw = sweep_batch_inputs(model, colors, "lambert_u8")
    b1 = time_raster(kw, raster_opts("lambert_u8", light), 100, 10)
    out["raster_vb2"] = b1
    say("timing", f"B1 view-batched (2 views, lambert_u8, "
        f"{int(kw['pair_tri'].numel())} pairs): kernel {b1['ms']:.4f} ms, "
        f"plain {b1['plain_ms']:.4f} ms; device {b1['device_ms']} ms in "
        f"{b1['device_ops']} device operations a call")
    return out, b1, raster_bound(kw)


def mid_span_cap(cx, cy):
    """The largest multiple of 128 below the spans' pair total at which
    B5's expansion is cut inside a triangle's span, past its first pair."""
    import numpy as np

    pc = cx.cpu().numpy().astype(np.int64) * cy.cpu().numpy()
    inclusive = np.cumsum(pc)
    total = int(inclusive[-1]) if pc.size else 0
    for cap in range((total - 1) // 128 * 128, 0, -128):
        tc = int(np.searchsorted(inclusive, cap, side="right"))
        if cap > inclusive[tc] - pc[tc]:
            return cap
    raise SmokeFailure(f"no slot cap below {total} pairs cuts inside a span")


def time_b5(spans, cap):
    """B5's wrapper and its plain version at ``cap``: CUDA-event ms a
    call, and the wrapper's device ms and device operations a call
    (torch.profiler)."""
    from cython3dmodelrenderer_tpu_torch.measure import (cuda_time_ms,
                                                         profile_calls)
    from cython3dmodelrenderer_tpu_torch.ops.binsort_grouped import (
        bin_sort_grouped, bin_sort_grouped_plain)

    def call():
        return bin_sort_grouped(*spans, cap, B5_GROUP, B5_SUB)

    dev_ms, ops = profile_calls(call, 20)
    return {"ms": cuda_time_ms(call, 50),
            "plain_ms": cuda_time_ms(lambda: bin_sort_grouped_plain(
                *spans, cap, B5_GROUP, B5_SUB), 20),
            "device_ms": dev_ms, "device_ops": ops}


def phase_b5(scenes):
    """B5 at sphere16k@1024²'s spans: the three caps' run and the launches
    it made (B4, B2 and the placement each launched once a cap);
    each output against both plain versions and a second run; timings."""
    import torch

    from cython3dmodelrenderer_tpu_torch.ops.binsort import bin_sort_plain
    from cython3dmodelrenderer_tpu_torch.ops.binsort_grouped import (
        bin_sort_grouped, bin_sort_grouped_plain, clamp_cut,
        place_from_bins_plain)

    tx0, cx, ty0, cy, ntx, nty, total = frame_setup(scenes["sphere16k"],
                                                    "lambert_u8", SIZE)[1]
    spans = (tx0, cx, ty0, cy, ntx, nty)
    demand = int(bin_sort_grouped_plain(*spans, 1 << 16, B5_GROUP, B5_SUB)[6])
    mid = mid_span_cap(cx, cy)
    tc, keep = clamp_cut(cx, cy, mid)
    require(0 < keep < int(cx[tc]) * int(cy[tc]),
            f"B5 mid-span cap {mid}: the cut falls at pair {keep} of "
            f"triangle {tc}'s span, not inside it")
    caps = (("ample", min(demand, (1 << 17) - 128)),
            ("undersized", 128 * (total // 256)), ("mid-span", mid))
    before = launch_counts("binsort_grouped", "binsort", "sort")
    runs = [bin_sort_grouped(*spans, cap, B5_GROUP, B5_SUB) for _t, cap in caps]
    torch.cuda.synchronize()
    launches = dict(zip(("placement", "binsort", "sort"),
                        launches_since(before).values()))
    require(all(n == len(caps) for n in launches.values()),
            f"B5 did not run B4, B2 and its placement once a call: {launches}")
    say("b5", f"kernel launches on B5's run ({len(caps)} calls): {launches}")
    err = 0
    bins = bin_sort_plain(tx0, cx, ty0, cy, ntx, nty, total)
    for (tag, cap), got in zip(caps, runs):
        again = bin_sort_grouped(*spans, cap, B5_GROUP, B5_SUB)
        want = bin_sort_grouped_plain(*spans, cap, B5_GROUP, B5_SUB)
        decomposed = place_from_bins_plain(bins, *spans, cap, B5_GROUP, B5_SUB)
        torch.cuda.synchronize()
        err = max([err] + [int((a - b).abs().max()) for a, b in zip(got, want)])
        require(len(got) == len(want) == 8
                and all(a.dtype == b.dtype and torch.equal(a, b)
                        for a, b in zip(got, want)),
                f"B5 {tag}: differs from the plain version")
        require(all(torch.equal(a, b) for a, b in zip(got, decomposed)),
                f"B5 {tag}: differs from place_from_bins_plain")
        require(all(torch.equal(a, b) for a, b in zip(got, again)),
                f"B5 {tag}: two runs differ")
        placed = int((got[0] != tx0.shape[0]).sum())
        require(0 < placed <= min(total, cap), f"B5 {tag}: {placed} placed")
        say("b5", f"bin_sort_grouped {tag} (slot_cap {cap}, {total} pairs, "
            f"{placed} placed, total_slots {int(got[6])}): bit-equal to both "
            "plain versions in all 8 outputs, deterministic")
    times = {}
    for tag, cap in caps[:2]:
        times[tag] = time_b5(spans, cap)
        say("timing", f"B5 bin_sort_grouped sphere16k@{SIZE} {tag} ({total} "
            f"pairs, slot_cap {cap}): kernel {times[tag]['ms']:.4f} ms, plain "
            f"{times[tag]['plain_ms']:.4f} ms (CUDA events); device "
            f"{times[tag]['device_ms']} ms in {times[tag]['device_ops']} "
            "device operations a call")
    return (launches["placement"], err, times,
            binning_bound(spans, runs[0], total))


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
                                                         profile_calls,
                                                         roofline_ms)
    from cython3dmodelrenderer_tpu_torch.probes import epi_prims, vpu_cal

    x2 = vpu_cal.make_input(device=DEVICE)
    x1, smat = epi_prims.make_input(DEVICE)
    before = launch_counts("vpu_cal", "epi_prims")
    cal = vpu_cal.calibrate(x2)
    vpu_cal.report(cal)
    slopes = {}
    for name in epi_prims.ALL_PRIMS:
        slopes[name] = epi_prims.measure(name, x1, smat)
        epi_prims.report(name, *slopes[name])
    torch.cuda.synchronize()
    launches = launches_since(before)
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
    p2_dev = profile_calls(lambda: vpu_cal.run_once(x2, P2_TIMED), 20)
    name, reps = P1_TIMED
    p1_ms = cuda_time_ms(lambda: epi_prims.run(name, reps, x1, smat), 20)
    p1_plain = cuda_time_ms(lambda: epi_prims.run_plain(name, reps, x1, smat),
                            2, warmup=1)
    p1_dev = profile_calls(lambda: epi_prims.run(name, reps, x1, smat), 20)
    say("probes", f"P1 {name} reps={reps}: device "
        f"{p1_dev[0]} ms in {p1_dev[1]} device operations a call; P2 "
        f"n_ops={P2_TIMED}: device {p2_dev[0]} ms in {p2_dev[1]}")
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
    device = {k: {"device_ms": d[0], "device_ops": d[1]}
              for k, d in (("vpu_cal", p2_dev), ("epi_prims", p1_dev))}
    return launches, {"vpu_cal": p2_err, "epi_prims": p1_err}, times, \
        bounds, probes, device


def check_bounds(tag, img, ref):
    """``test_golden_standalone``'s bounds (tests/test_renderer.py:315-325)
    of ``img`` against ``ref``; returns (IoU, MAE, >20 fraction)."""
    ours, gold = img.float(), ref.float()
    ours_mask, gold_mask = ours.sum(-1) > 15, gold.sum(-1) > 15
    iou = float((ours_mask & gold_mask).sum() / (ours_mask | gold_mask).sum())
    both = ours_mask & gold_mask
    mae = float((ours[both] - gold[both]).abs().mean())
    big = float(((ours - gold).abs().amax(-1) > 20).float().mean())
    require(iou > 0.998 and mae < 0.5 and big < 0.002,
            f"{tag}: IoU {iou}, MAE {mae}, >20 fraction {big}")
    return iou, mae, big


def on_card(*tensors):
    return all(t.device.type == "cuda" for t in tensors)


def ratio_work(model):
    """What a ratio frame of ``model`` at SIZE² evaluates: the bbox bucket,
    JAX's scan steps and window fragments (steps x chunk x bbox²), and the
    port's fragments (each bbox cut at the window)."""
    from cython3dmodelrenderer_tpu_torch.config import RenderConfig
    from cython3dmodelrenderer_tpu_torch.fillers import ratio_chunk
    from cython3dmodelrenderer_tpu_torch.ops import raster_ref
    from cython3dmodelrenderer_tpu_torch.ops.projection import (
        project_to_screen, visibility_masks)

    config = RenderConfig(height=SIZE, width=SIZE, fov=FOV)
    tv, tn = model.vertices_by_triangles, model.normals_by_triangles
    deg, back = visibility_masks(tv, tn)
    ts, active = project_to_screen(tv, config), ~deg & ~back
    bbox = raster_ref.required_bbox_size(ts, active, config)
    chunk = ratio_chunk(bbox)
    steps = -(-model.n_triangles() // chunk)
    n_frag = raster_ref.window_fragments(ts, active, config, bbox)[3]
    return {"bbox": bbox, "chunk": chunk, "jax_steps": steps,
            "jax_window_fragments": steps * chunk * bbox * bbox,
            "port_fragments": int(n_frag.sum())}


def surface_ratio(scenes, results, light):
    """The "ratio" backend at 1024² against the kernel frames, its ms/frame,
    and at 512² against the same render on CPU tensors."""
    import torch

    from cython3dmodelrenderer_tpu_torch import AdvancedPixelBufferFiller
    from cython3dmodelrenderer_tpu_torch.measure import cuda_time_ms

    out = {}
    for name in ("igor_sphere", "sphere16k"):
        out[f"{name}@{SIZE}"] = ratio_work(scenes[name])
        say("surface", f"ratio {name}@{SIZE}: {out[f'{name}@{SIZE}']}")
        for iname in ("guro", "none"):
            kernel_renderer, kernel_img, _img2, kernel_z = results[(name, iname)]
            renderer = make_renderer(kernel_renderer.illumination, "ratio")
            img = seeded_render(renderer, scenes[name])
            again = seeded_render(renderer, scenes[name])
            z = renderer.z_buffer.array
            require(torch.equal(img, again),
                    f"ratio {name}/{iname}: renders differ")
            require(on_card(img, z), f"ratio {name}/{iname}: left the card")
            iou, mae, big = check_bounds(f"ratio {name}/{iname}", img,
                                         kernel_img)
            ms = cuda_time_ms(lambda: renderer.render(scenes[name]),
                              SURFACE_WARM_FRAMES)
            # z mismatch as tests_tpu/test_tpu_parity.py:42-43 counts it
            row = out[f"{name}/{iname}@{SIZE}"] = {
                "ms_per_frame": ms, "iou": iou, "mae": mae,
                "frac_over_20": big,
                "z_mismatch": float(((z - kernel_z).abs() > 1e-3).float().mean()),
                "z_bits_differ": float((z != kernel_z).float().mean()),
                "pixels_differing": int((img != kernel_img).any(-1).sum())}
            say("surface", f"ratio {name} {iname}@{SIZE}: {ms:.4f} ms/frame "
                f"(median of {SURFACE_WARM_FRAMES} warm, CUDA events); against "
                f"the kernel frame IoU {iou:.6f}, MAE {mae:.6f}, >20 {big}, z "
                f"mismatch (|dz| > 1e-3) {row['z_mismatch']}, z bits differ "
                f"at {row['z_bits_differ']:.4f} of pixels (plane vs ratio "
                f"form), {row['pixels_differing']} pixels differ")
    size = SURFACE_CPU_SIZE
    model = scenes["igor_sphere"]
    args = (model.vertices_by_triangles, model.normals_by_triangles,
            seeded_colors(model))
    frames = []
    for device, tensors in ((DEVICE, args), (DEVICE, args),
                            ("cpu", [t.cpu() for t in args])):
        filler = AdvancedPixelBufferFiller(size, size, fov=FOV, device=device,
                                           backend="ratio")
        filler.render_arrays(*tensors, post="lambert_u8", light=light)
        snap = filler.snapshot_buffers()
        require(device == "cpu" or on_card(*snap),
                f"ratio igor_sphere@{size}: left the card")
        frames.append([t.cpu() for t in snap])
    for k, part in enumerate(("color", "z", "normal", "image")):
        require(all(same_bits(frames[0][k], f[k]) for f in frames[1:]),
                f"ratio igor_sphere@{size} {part}: the card's render != the "
                "CPU render (or a second call)")
    say("surface", f"ratio igor_sphere@{size} lambert_u8: colour, z, normal "
        "and image bit-equal to the same render on CPU tensors and to a "
        "second call")
    return out


def surface_turntable(tt_model, colors):
    """``multiview.render_turntable`` over the sweep phase's 8 poses of
    sphere16k; every view against ``render_view`` of its posed arrays."""
    import torch

    from cython3dmodelrenderer_tpu_torch.config import RenderConfig
    from cython3dmodelrenderer_tpu_torch.measure import cuda_time_ms
    from cython3dmodelrenderer_tpu_torch.parallel import multiview

    config = RenderConfig(height=SIZE, width=SIZE, fov=FOV)
    tv, tn = tt_model.vertices_by_triangles, tt_model.normals_by_triangles
    angles = sweep_angles()

    def turntable():
        return multiview.render_turntable(tv, tn, colors, angles, config,
                                          post_shift=SWEEP_SHIFT)

    views = turntable()
    require(views.shape == (SWEEP_VIEWS, SIZE, SIZE, 3) and on_card(views),
            f"render_turntable: {tuple(views.shape)} on {views.device}")
    for i, angle in enumerate(angles):
        v, n = multiview._pose_triangles(tv, tn, angle, SWEEP_SHIFT)
        single = multiview.render_view(v, n, colors, config)[0]
        require(same_bits(views[i], single),
                f"render_turntable view {i}: != render_view of its pose")
    lit = float((views.amax(-1) > 0).float().mean())
    require(lit > 0.05 and bool(torch.isfinite(views).all()),
            f"render_turntable: {lit} of pixels lit")
    ms = cuda_time_ms(turntable, 2, warmup=1) / SWEEP_VIEWS
    say("surface", f"render_turntable sphere16k@{SIZE}: {SWEEP_VIEWS} views "
        f"each bit-equal to render_view of its posed arrays, {lit:.4f} of "
        f"pixels lit, {ms:.4f} ms/view (CUDA events, median of 2 sweeps / "
        f"{SWEEP_VIEWS})")
    return {"ms_per_view": ms, "views": SWEEP_VIEWS}


def surface_per_triangle(model):
    """Every igor_sphere triangle, as host arrays, through
    ``compute_triangle_statistics`` on CUDA Buffers, against the ratio
    backend's frame of the model."""
    import torch

    from cython3dmodelrenderer_tpu_torch import (AdvancedPixelBufferFiller,
                                                 Buffer)

    tv, tn = model.vertices_by_triangles, model.normals_by_triangles
    tc = seeded_colors(model)
    filler = AdvancedPixelBufferFiller(SIZE, SIZE, fov=FOV, device=DEVICE,
                                       backend="ratio")
    filler.render_arrays(tv, tn, tc)
    ref_color, ref_z, _n = filler.snapshot_buffers()[:3]
    bufs = (Buffer(SIZE, SIZE, dim=3, dtype="float32", device=DEVICE),
            Buffer(SIZE, SIZE, dim=1, dtype="float32", init_val=1e6,
                   device=DEVICE),
            Buffer(SIZE, SIZE, dim=3, dtype="float32", device=DEVICE))
    n = model.n_triangles()
    # host arrays, as the Renderer's triangle iterator yields them
    tris, cols, norms = (t.cpu().numpy() for t in (tv, tc, tn))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        filler.compute_triangle_statistics(tris[i], cols[i], norms[i], *bufs)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / n
    color, z = bufs[0].array, bufs[1].array
    require(on_card(color, z, bufs[2].array),
            "compute_triangle_statistics: buffers left the card")
    z_bits = same_bits(z, ref_z)
    z_err = float((z - ref_z).abs().max())
    require(z_bits or z_err <= 1e-5,
            f"compute_triangle_statistics z: {z_err} from the ratio frame")
    c_err = float((color - ref_color).abs().max())
    require(c_err <= 0.05, f"compute_triangle_statistics colour: {c_err} from "
            "the ratio frame")
    covered = float((z < 1.0).float().mean())
    require(covered > 0.05, f"compute_triangle_statistics: {covered} covered")
    say("surface", f"compute_triangle_statistics igor_sphere@{SIZE}: {n} "
        f"triangles on CUDA Buffers, {ms:.4f} ms per triangle (wall); z "
        f"{'bit-equal to' if z_bits else f'within {z_err} of'} the ratio "
        f"frame's, colour within {c_err} (bit-equal: "
        f"{same_bits(color, ref_color)}), {covered:.4f} of pixels covered")
    return {"ms_per_triangle": ms, "triangles": n, "z_bit_equal": z_bits,
            "z_max_abs_err": z_err, "color_max_abs_err": c_err}


def surface_custom_drawer(model):
    """A custom drawer through ``Renderer.render`` on the cuda backend:
    B1 launches, and the frame is ``cast_u8(apply(...))`` of the filler's
    snapshot and the plain path's frame."""
    import torch

    from cython3dmodelrenderer_tpu_torch import IlluminationDrawer
    from cython3dmodelrenderer_tpu_torch.ops.illumination import cast_u8

    class Tint(IlluminationDrawer):
        def apply(self, color, n_buffer):
            return color * 0.5 + n_buffer[..., 2:3].abs() * 100.0

    renderer = make_renderer(Tint(), "cuda")
    before = launch_counts("raster")
    img = seeded_render(renderer, model)
    torch.cuda.synchronize()
    launches = launches_since(before)["raster"]
    require(launches > 0, "custom drawer: B1 was not launched")
    color, z, normals, _img = renderer.pixel_buffer_filler.snapshot_buffers()
    require(torch.equal(img, cast_u8(Tint().apply(color, normals)))
            and same_bits(renderer.z_buffer.array, z),
            "custom drawer: frame != cast_u8(apply(snapshot_buffers()))")
    plain = seeded_render(make_renderer(Tint(), "torch"), model)
    require(torch.equal(img, plain), "custom drawer: kernel frame != plain")
    lit = float((img.amax(-1) > 0).float().mean())
    require(lit > 0.05 and on_card(img), f"custom drawer: {lit} lit")
    say("surface", f"custom IlluminationDrawer igor_sphere@{SIZE} on the cuda "
        f"backend: B1 launched {launches}x, == cast_u8(apply(snapshot)), == "
        f"the plain path, {lit:.4f} of pixels lit")
    return {"raster_launches": launches}


def surface_wireframe():
    """The LineBresenham wireframe of sphere16k at 1024² against the same
    lines drawn on CPU tensors, and a recording LineDrawer on the cube."""
    import torch

    from cython3dmodelrenderer_tpu_torch import (EdgeOnlyPixelBufferFiller,
                                                 LineBresenham, LineDrawer,
                                                 Model, NoIllumination,
                                                 Renderer, SimpleIterator)
    from cython3dmodelrenderer_tpu_torch.measure import cuda_time_ms

    out = {}
    for kind, draw_edges in (("edges", True), ("vertices", False)):
        model = posed(Model(*displaced_sphere(TRI_SPHERE_SEGMENTS,
                                              TRI_SPHERE_RINGS), device=DEVICE),
                      True)
        filler = EdgeOnlyPixelBufferFiller(LineBresenham(), [255, 255, 255],
                                           draw_edges=draw_edges)
        renderer = Renderer(filler, NoIllumination(), SimpleIterator, SIZE,
                            SIZE, device=DEVICE)
        img = renderer.render(model, normalize_model=True).array.clone()
        tv = model.vertices_by_triangles
        cpu = filler.fill_all(tv.cpu(), torch.zeros(tv.shape),
                              torch.zeros((SIZE, SIZE, 3))).to(torch.uint8)
        require(on_card(img) and torch.equal(img.cpu(), cpu),
                f"wireframe {kind}: the card's frame != fill_all on the CPU")
        lit = int((img.amax(-1) > 0).sum())
        require(lit > 0 and int(img.max()) == 255, f"wireframe {kind}: {lit}")

        ms = cuda_time_ms(lambda: renderer.render(model), SURFACE_WARM_FRAMES)
        out[kind] = {"ms_per_frame": ms, "lit_pixels": lit}
        say("surface", f"wireframe sphere16k@{SIZE} {kind}: == fill_all on CPU "
            f"tensors, {lit} pixels lit, {ms:.4f} ms/frame (median of "
            f"{SURFACE_WARM_FRAMES} warm, CUDA events)")

    class Recording(LineDrawer):
        def __init__(self):
            self.calls = 0

        def draw_line(self, p1, p2, image, color):
            self.calls += 1

    root = os.path.dirname(os.path.abspath(__file__))
    cube = Model.read_model(os.path.join(root, "assets", "cube.obj"),
                            device=DEVICE)
    drawer = Recording()
    Renderer(EdgeOnlyPixelBufferFiller(drawer, [255, 255, 255]),
             NoIllumination(), SimpleIterator, 64, 64,
             device=DEVICE).render(cube, normalize_model=True)
    require(drawer.calls == 3 * cube.n_triangles(),
            f"recording LineDrawer: {drawer.calls} edges, want "
            f"{3 * cube.n_triangles()}")
    say("surface", f"recording LineDrawer: {drawer.calls} edges of "
        f"{cube.n_triangles()} cube triangles")
    return out


def phase_surface(scenes, results, tt_model, colors, light, smi):
    """Phase 10; returns the ``surface`` line's object."""
    surface = {"ratio": surface_ratio(scenes, results, light),
               "turntable": surface_turntable(tt_model, colors),
               "per_triangle": surface_per_triangle(scenes["igor_sphere"]),
               "custom_drawer": surface_custom_drawer(scenes["igor_sphere"]),
               "wireframe": surface_wireframe(), "smi": smi}
    return surface


# ---------------------------------------------------------------------------
# phase 11: sharded rendering over torch.distributed
# ---------------------------------------------------------------------------

def sharded_cases(world, arrays):
    """This rank's part of phase 11 on a world of ``world`` ranks (the
    default process group is up): the view-sharded sphere16k turntable at
    each of SHARD_VIEW_BATCHES and the triangle-sharded torus262k frame on
    the cuda backend, both against the unsharded render on this rank's
    card, then the ratio backend at SHARD_RATIO_SIZE². Returns this rank's
    launches, checks and CUDA-event ms."""
    import torch

    from cython3dmodelrenderer_tpu_torch.config import RenderConfig
    from cython3dmodelrenderer_tpu_torch.device import resolve_device
    from cython3dmodelrenderer_tpu_torch.measure import cuda_time_ms
    from cython3dmodelrenderer_tpu_torch.parallel import multiview
    from cython3dmodelrenderer_tpu_torch.parallel.mesh import make_mesh

    views = make_mesh([("views", world)])           # no device: the card
    tris = make_mesh([("tris", world)])
    rank = views.get_local_rank("views")
    dev = resolve_device(DEVICE)          # make_mesh selected the card
    sv, sn, sc = (torch.from_numpy(a).to(dev) for a in arrays["sphere"])
    tv, tn, tc = (torch.from_numpy(a).to(dev) for a in arrays["torus"])
    config = RenderConfig(height=SIZE, width=SIZE, fov=FOV)
    angles = sweep_angles()
    per = SWEEP_VIEWS // world
    mine_angles = angles[rank * per:(rank + 1) * per]
    tag = f"world {world} rank {rank}"
    out = {"rank": rank, "device": str(dev)}

    def launches_of(fn):
        before = launch_counts("raster", "sort", "binsort", "frontend",
                               "reruns")
        res = fn()
        torch.cuda.synchronize()
        return res, launches_since(before)

    for vb in SHARD_VIEW_BATCHES:
        def sharded():
            return multiview.render_turntable_sharded(
                sv, sn, sc, angles, config, views, post_shift=SWEEP_SHIFT,
                backend="cuda", view_batch=vb)

        got, launches = launches_of(sharded)
        want = multiview.render_turntable_pallas(
            sv, sn, sc, mine_angles, config, post_shift=SWEEP_SHIFT,
            view_batch=vb)
        require(got.shape == (per, SIZE, SIZE, 3) and same_bits(got, want),
                f"sharded {tag} view_batch={vb}: its views != the unsharded "
                "sweep's")
        require(launches["raster"] - launches["reruns"] == launches["frontend"]
                == per // vb,
                f"sharded {tag} view_batch={vb}: B1 / F1 launched "
                f"{launches['raster']} / {launches['frontend']} times, not "
                f"{per // vb}")
        ms = cuda_time_ms(sharded, SHARD_REPS, warmup=2)
        out[f"views_vb{vb}"] = {"launches": launches, "ms_per_call": ms,
                                "ms_per_view": ms / SWEEP_VIEWS}

    def frame(check_capacity=False):
        return multiview.render_triangle_sharded(
            tv, tn, tc, config, tris, backend="cuda",
            check_capacity=check_capacity)

    (color, z, normal, used), launches = launches_of(lambda: frame(True))
    c0, z0, n0, total = multiview._render_view_kernel(
        tv, tn, tc, config, multiview._norm_light((0.0, 0.0, 1.0)), "cuda")
    # a winner's -0.0 reads +0.0 through the merge's sum of two or more
    # ranks; z is the winner's own, ±0 included
    fold = (lambda x: x) if world == 1 else (lambda x: x + 0.0)
    require(same_bits(z, z0),
            f"sharded {tag} torus262k: merged z != the unsharded frame's")
    require(same_bits(color, fold(c0)) and same_bits(normal, fold(n0)),
            f"sharded {tag} torus262k: merged colour/normal != the unsharded "
            "frame's")
    require(launches["binsort"] > 0 and launches["raster"] > 0
            and launches["sort"] == 0 and launches["frontend"] == 1,
            f"sharded {tag} torus262k: not F1 once, B4 + B1 alone: {launches}")
    ms = cuda_time_ms(frame, SHARD_REPS, warmup=2)
    out["frame"] = {"launches": launches, "ms_per_frame": ms, "mesh_max_pairs":
                    used, "unsharded_pairs": total}

    small = RenderConfig(height=SHARD_RATIO_SIZE, width=SHARD_RATIO_SIZE, fov=FOV)
    got = multiview.render_turntable_sharded(sv, sn, sc, angles, small, views,
                                             post_shift=SWEEP_SHIFT)
    want = multiview.render_turntable(sv, sn, sc, mine_angles, small,
                                      post_shift=SWEEP_SHIFT)
    require(same_bits(got, want) and on_card(got),
            f"sharded {tag} ratio turntable@{SHARD_RATIO_SIZE}: != unsharded")
    pv, pn = multiview._pose_triangles(sv, sn, angles[0], SWEEP_SHIFT)
    _c, z, _n = multiview.render_triangle_sharded(pv, pn, sc, small, tris)
    z0 = multiview.render_view(pv, pn, sc, small)[1]
    require(same_bits(z, z0), f"sharded {tag} ratio frame@{SHARD_RATIO_SIZE}: "
            "merged z != the unsharded frame's")
    return out


def sharded_rank(rank, world, init_file, arrays, out_dir):
    """A spawned rank of phase 11: gloo (NCCL refuses two ranks on one
    card; gloo's collectives take CUDA tensors), then ``sharded_cases``;
    an exception here fails the spawn and so the smoke."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        result = sharded_cases(world, arrays)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)


def phase_sharded(tt_model, sweep_colors, torus, smi):
    """Phase 11; returns the ``sharded`` line's object."""
    import tempfile

    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from cython3dmodelrenderer_tpu_torch.config import RenderConfig
    from cython3dmodelrenderer_tpu_torch.examples import multichip
    from cython3dmodelrenderer_tpu_torch.measure import cuda_time_ms
    from cython3dmodelrenderer_tpu_torch.parallel import multiview

    t_phase = time.perf_counter()
    arrays = {"sphere": [t.cpu().numpy() for t in (
                  tt_model.vertices_by_triangles, tt_model.normals_by_triangles,
                  sweep_colors)],
              "torus": [t.cpu().numpy() for t in (
                  torus.vertices_by_triangles, torus.normals_by_triangles,
                  seeded_colors(torus))]}
    out = {"smi": smi, "views": SWEEP_VIEWS, "size": SIZE,
           "torus_triangles": torus.n_triangles(), "unsharded": {}}
    config = RenderConfig(height=SIZE, width=SIZE, fov=FOV)
    sv, sn = tt_model.vertices_by_triangles, tt_model.normals_by_triangles
    for vb in SHARD_VIEW_BATCHES:
        ms = cuda_time_ms(lambda: multiview.render_turntable_pallas(
            sv, sn, sweep_colors, sweep_angles(), config,
            post_shift=SWEEP_SHIFT, view_batch=vb), SHARD_REPS, warmup=2)
        out["unsharded"][f"views_vb{vb}"] = {"ms_per_call": ms,
                                             "ms_per_view": ms / SWEEP_VIEWS}
    tv, tn, tc = (torch.from_numpy(a).to(DEVICE) for a in arrays["torus"])
    light = multiview._norm_light((0.0, 0.0, 1.0))
    out["unsharded"]["frame"] = {"ms_per_frame": cuda_time_ms(
        lambda: multiview._render_view_kernel(tv, tn, tc, config, light,
                                              "cuda"), SHARD_REPS, warmup=2)}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/pg1",
                                rank=0, world_size=1)
        try:
            out["world1"] = [sharded_cases(1, arrays)]
        finally:
            dist.destroy_process_group()
        t0 = time.perf_counter()
        mp.spawn(sharded_rank, args=(2, f"{tmp}/pg2", arrays, tmp), nprocs=2,
                 join=True)
        out["world2_spawn_s"] = time.perf_counter() - t0
        out["world2"] = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                out["world2"].append(json.load(f))
    t0 = time.perf_counter()
    multichip.main(2)            # the example's own checks, 2 ranks on the card
    out["multichip_example_s"] = time.perf_counter() - t0
    out["phase_s"] = time.perf_counter() - t_phase
    for world in SHARD_WORLDS:
        for res in out[f"world{world}"]:
            views = ", ".join(
                f"vb {vb}: {res[f'views_vb{vb}']['ms_per_view']:.4f} ms/view "
                f"(B1 x{res[f'views_vb{vb}']['launches']['raster']})"
                for vb in SHARD_VIEW_BATCHES)
            fr = res["frame"]
            say("sharded", f"world {world} rank {res['rank']} on "
                f"{res['device']}: views == unsharded, {views}; torus262k "
                f"z bit-equal to unsharded, {fr['ms_per_frame']:.4f} ms/frame, launches "
                f"{fr['launches']}, mesh max pairs {fr['mesh_max_pairs']} of "
                f"{fr['unsharded_pairs']}; ratio@{SHARD_RATIO_SIZE} == unsharded")
    unsharded = out["unsharded"]
    say("sharded", "unsharded: " + ", ".join(
        f"vb {vb}: {unsharded[f'views_vb{vb}']['ms_per_view']:.4f} ms/view"
        for vb in SHARD_VIEW_BATCHES)
        + f"; torus262k {unsharded['frame']['ms_per_frame']:.4f} ms/frame "
        f"(CUDA events, median of {SHARD_REPS}; {smi})")
    return out


# ---------------------------------------------------------------------------
# phase 12: the host-side surface
# ---------------------------------------------------------------------------

def write_obj(path, verts, faces):
    """An OBJ of ``verts`` (float32, 9 significant digits: exact) and
    1-based ``faces``."""
    import numpy as np

    with open(path, "w") as f:
        np.savetxt(f, verts, fmt="v %.9g %.9g %.9g")
        np.savetxt(f, faces + 1, fmt="f %d %d %d")


def same_parse(a, b):
    import numpy as np

    for field in ("vertices", "texture_coords", "normals", "faces_v",
                  "faces_vt", "faces_vn", "texture"):
        x, y = getattr(a, field), getattr(b, field)
        if (x is None) != (y is None) or (y is not None and (
                x.dtype != y.dtype or not np.array_equal(x, y))):
            return False
    return True


def host_parser():
    """The native parser against the Python parser on every in-repo mesh
    and on sphere16k and torus262k written out as OBJ; ms of each."""
    import glob
    import tempfile

    from cython3dmodelrenderer_tpu_torch.models import obj_io
    from cython3dmodelrenderer_tpu_torch.native import objparse_native

    require(objparse_native.available(),
            "the native OBJ parser did not build (no g++ on the card's host?)")
    root = os.path.dirname(os.path.abspath(__file__))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        paths = sorted(glob.glob(os.path.join(root, "assets", "*.obj")))
        for name, mesh in (("sphere16k", displaced_sphere(TRI_SPHERE_SEGMENTS,
                                                          TRI_SPHERE_RINGS)),
                           ("torus262k", displaced_torus(*TORUS_QUADS))):
            paths.append(os.path.join(tmp, f"{name}.obj"))
            write_obj(paths[-1], *mesh)
        for path in paths:
            t0 = time.perf_counter()
            nat = obj_io._try_native(path, True, None)
            t1 = time.perf_counter()
            py = obj_io._load_obj_python(path)
            t2 = time.perf_counter()
            name = os.path.basename(path)
            require(nat is not None and same_parse(nat, py),
                    f"native parse of {name} != the Python parser's")
            out[name] = {"triangles": int(py.faces_v.shape[0]),
                         "native_ms": (t1 - t0) * 1e3,
                         "python_ms": (t2 - t1) * 1e3}
            say("host", f"{name}: native parse == Python parse, "
                f"{py.faces_v.shape[0]} triangles, native "
                f"{out[name]['native_ms']:.2f} ms, Python "
                f"{out[name]['python_ms']:.2f} ms (host clock, one parse)")
    return out


def host_compat(scenes):
    """The compat cy.Renderer at SIZE² on igor_sphere against the port
    Renderer's frame and the filler's shaded G-buffers."""
    import numpy as np
    import torch

    from cython3dmodelrenderer_tpu_torch import GuroIllumination, crender
    from cython3dmodelrenderer_tpu_torch.ops.illumination import cast_u8

    cy = crender.cy
    model = scenes["igor_sphere"]
    filler = cy.pixel_buffer_filler.AdvancedPixelBufferFiller(SIZE, SIZE,
                                                               fov=FOV)
    renderer = cy.Renderer(filler, cy.illumination.GuroIllumination([0, 0, 1]),
                           cy.triangle_iterator.SimpleIterator, SIZE, SIZE,
                           generator=torch.Generator().manual_seed(7))
    frame = renderer.render(model)
    shaded = GuroIllumination([0, 0, 1]).apply(filler.get_color_buffer(),
                                               filler.get_normals_buffer())
    require(isinstance(frame, np.ndarray) and frame.dtype == np.float32
            and frame.shape == (SIZE, SIZE, 3) and on_card(shaded),
            f"compat cy.Renderer: {type(frame)}, filler on {filler.device}")
    port = seeded_render(make_renderer(GuroIllumination([0, 0, 1]), size=SIZE),
                         model)
    frame = torch.from_numpy(frame)
    require(same_bits(frame, shaded.cpu())
            and torch.equal(cast_u8(frame), port.cpu()),
            "compat cy.Renderer: != the port Renderer's shaded frame")
    say("host", f"compat cy.Renderer igor_sphere@{SIZE}: host float32 == the "
        "filler's G-buffers shaded, and cast to uint8 == the port Renderer's "
        "frame")
    return {"igor_sphere_lit": float((frame.amax(-1) > 0).float().mean())}


def host_timing(scenes, results):
    """``utils.timing.time_frames`` beside ``measure.cuda_time_ms`` on one
    sphere16k Guro frame."""
    from cython3dmodelrenderer_tpu_torch.measure import cuda_time_ms
    from cython3dmodelrenderer_tpu_torch.utils.timing import time_frames

    renderer, model = results[("sphere16k", "guro")][0], scenes["sphere16k"]
    wall = time_frames(lambda: renderer.render(model), n_warm=5, n_iter=20)
    event = cuda_time_ms(lambda: renderer.render(model), 20)
    say("host", f"sphere16k@{SIZE} guro: time_frames {wall:.4f} ms/frame (mean "
        f"wall of 20, fenced), cuda_time_ms {event:.4f} ms (median of 20)")
    return {"time_frames_ms": wall, "cuda_time_ms": event}


def host_turntable_example():
    """The turntable example at SWEEP_VIEWS views (no PNGs: the card's host
    has no OpenCV), against the sweep on the same model."""
    import torch

    from cython3dmodelrenderer_tpu_torch.config import RenderConfig
    from cython3dmodelrenderer_tpu_torch.examples import turntable
    from cython3dmodelrenderer_tpu_torch.parallel import multiview

    frames, ms = turntable.main(SWEEP_VIEWS, SIZE, view_batch=4, write=False)
    model, colors, post_shift = turntable.load_model(DEVICE)
    want = multiview.render_turntable_pallas(
        model.vertices_by_triangles, model.normals_by_triangles, colors,
        multiview.turntable_angles(SWEEP_VIEWS),
        RenderConfig(height=SIZE, width=SIZE, fov=45), post_shift=post_shift)
    lit = float((frames.amax(-1) > 0).float().mean())
    require(on_card(frames) and same_bits(frames, want) and lit > 0.05
            and bool(torch.isfinite(frames).all()),
            f"turntable example: {lit} lit, on {frames.device}")
    say("host", f"examples.turntable: {SWEEP_VIEWS} views at {SIZE}² == the "
        f"view_batch=1 sweep, {lit:.4f} of pixels lit, {ms:.4f} ms/view")
    return {"ms_per_view": ms}


def phase_host(scenes, results, smi):
    """Phase 12; returns the ``host`` line's object."""
    t0 = time.perf_counter()
    out = {"parser": host_parser(), "compat": host_compat(scenes),
           "timing": host_timing(scenes, results),
           "turntable_example": host_turntable_example(), "smi": smi}
    out["phase_s"] = time.perf_counter() - t0
    return out


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
        phase_kernels_frontend(scenes, light)
        colors_ms = phase_kernels_colors()
        launches, results = phase_main(scenes)
        frame_ms, kt, bounds = phase_timing(scenes, results, inputs, light)
        large = load_large_scenes("cuda", scenes)
        binsort_err, b3_err, large_inputs = phase_kernels_large(large, light)
        large_launches, large_results = phase_large(large)
        large_ms, large_kt, large_bounds = phase_timing_large(
            large, large_results, large_inputs, light)
        capacity = phase_capacity(light, smi)
        tt_model = turntable_model(DEVICE)
        sweep_launches, sweep_renderers, sweep_colors = phase_sweep(tt_model,
                                                                    light)
        sweep_err = phase_kernels_sweep(tt_model, sweep_colors, light)
        sweep_ms, sweep_kt, sweep_bound = phase_timing_sweep(
            sweep_renderers, tt_model, sweep_colors, light, frame_ms)
        b5_launches, b5_err, b5_ms, b5_bound = phase_b5(scenes)
        (probe_launches, probe_err, probe_ms, probe_bounds, probes,
         probe_dev) = phase_probes()
        surface = phase_surface(scenes, results, tt_model, sweep_colors, light,
                                smi)
        sharded = phase_sharded(tt_model, sweep_colors, large["torus262k"], smi)
        host = phase_host(scenes, results, smi)
    except SmokeFailure as e:
        print(f"FAIL: {e}", flush=True)
        return 1
    frame_ms.update(large_ms)
    frame_ms["sweep_ms_per_view"] = sweep_ms
    frame_ms["b5_sphere16k@1024"] = b5_ms
    frame_ms["vertex_colors"] = colors_ms
    frame_ms["capacity"] = capacity

    def entry(name, source, replaces, n, err, times, bound, library=None,
              device=None):
        out = {"name": name, "route": "cuda",
               "source": f"cython3dmodelrenderer_tpu_torch/csrc/{source}",
               "replaces": replaces, "launches": n, "max_abs_err": err,
               "ms": times[0], "plain_ms": times[1], "bound_ms": bound[0],
               "bound_by": bound[1], "library_ms": library}
        if device is not None:          # the kernel time under the profiler
            out.update(device_ms=device["device_ms"],
                       device_ops=device["device_ops"])
        return out

    pkg = "cython3dmodelrenderer_tpu/ops/"
    glue = ("cython3dmodelrenderer_tpu/fillers.py:54 + "
            "cython3dmodelrenderer_tpu/ops/binning.py:52 (XLA glue, not a "
            "pallas_call site)")

    def f1_entry(tag, n, t):            # every F1 check is bit for bit
        return entry(f"frame_planes (F1) {tag}", "frontend.cu", glue, n, 0.0,
                     (t["ms"], t["plain_ms"]), t["bound"], device=t)

    kernels = [
        entry("raster_tiles (B1)", "raster.cu", pkg + "raster_pallas.py:293",
              launches["raster"], raster_err, kt["raster"], bounds["raster"],
              device=frame_ms["raster_sphere16k@1024"]),
        # B2's plain version is torch.sort itself: its time is the library's
        entry("sort_i32 (B2)", "radix_sort.cu", pkg + "sort_pallas.py:32",
              launches["sort"], sort_err, kt["sort"], bounds["sort"],
              library=kt["sort"][1]),
        entry("bin_sort (B4)", "radix_sort.cu", pkg + "binsort_pallas.py:42",
              large_launches["binsort"], binsort_err, large_kt["binsort"],
              large_bounds["binsort"]),
        entry("raster_tiles on bin_sort bins (B3)", "raster.cu",
              pkg + "raster_pallas.py:142", large_launches["raster"], b3_err,
              large_kt["b3_route"], large_bounds["b3_route"],
              device=large_ms["raster_b3_route_torus262k@1024"]),
        entry("raster_tiles view-batched (B1/B3 tiles_per_view)", "raster.cu",
              pkg + "raster_pallas.py:293", sweep_launches["raster_batched"],
              sweep_err, (sweep_kt["ms"], sweep_kt["plain_ms"]), sweep_bound,
              device=sweep_kt),
        entry("bin_sort_grouped (B5)", "binsort_grouped.cu",
              pkg + "binsort_pallas.py:106", b5_launches, b5_err,
              (b5_ms["ample"]["ms"], b5_ms["ample"]["plain_ms"]), b5_bound,
              device=b5_ms["ample"]),
        entry("vpu_cal (P2)", "vpu_cal.cu", "tools/probes/vpu_cal.py:51",
              probe_launches["vpu_cal"], probe_err["vpu_cal"],
              probe_ms["vpu_cal"], probe_bounds["vpu_cal"],
              device=probe_dev["vpu_cal"]),
        entry("epi_prims epi_cur6 x128 (P1)", "epi_prims.cu",
              "tools/probes/epi_prims.py:275", probe_launches["epi_prims"],
              probe_err["epi_prims"], probe_ms["epi_prims"],
              probe_bounds["epi_prims"], device=probe_dev["epi_prims"]),
        f1_entry(f"sphere16k@{SIZE} C=6", launches["frontend"],
                 frame_ms[f"frontend_sphere16k@{SIZE}_c6"]),
        f1_entry(f"torus262k@{SIZE} C=6", large_launches["frontend"],
                 large_ms[f"frontend_torus262k@{SIZE}_c6"]),
        f1_entry("sweep batch x4 C=6", sweep_launches["frontend_batched"],
                 sweep_ms["frontend_vb4"]),
    ] + [
        # checked bit for bit; launches: the main path's untextured frames
        entry(f"vertex_colors {tag}", "colors.cu",
              "cython3dmodelrenderer_tpu/renderer.py:92 (a NumPy draw on "
              "the host and its copy, not a pallas_call site)",
              launches["colors"], 0.0, (c["ms"], c["plain_ms"]), c["bound"])
        for tag, c in colors_ms.items()]
    print(json.dumps({"frame_ms": frame_ms}), flush=True)
    print(json.dumps({"probes": probes}), flush=True)
    print(json.dumps({"surface": surface}), flush=True)
    print(json.dumps({"sharded": sharded}), flush=True)
    print(json.dumps({"host": host}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
