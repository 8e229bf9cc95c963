"""Port raster path (plain PyTorch) against JAX ``render_frame``.

The JAX side is ``raster_pallas.render_frame(..., group=16,
interpret=True)`` — the grouped Pallas kernel in interpret mode, as the JAX
package's own tests run it. It runs in a subprocess (this file, run as a
script) with ``XLA_FLAGS=--xla_cpu_max_isa=AVX``: by default XLA:CPU
contracts ``a*b + c`` into FMAs inside the jitted reference, which moves
plane values by an ulp and flips edge pixels (0.05% of the igor_sphere
image at 64², z off by up to 3.6e-5). Without FMA instructions XLA
evaluates the kernel source's own operation order, and the port must then
agree BIT FOR BIT: z, colour and normal G-buffers and both u8 images.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIGHT_DIR = (0.3, -0.2, 1.0)


def random_scene(t, seed):
    """Random front-facing triangles around z≈1 (tests/test_raster.py)."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-0.4, 0.4, size=(t, 1, 3)).astype(np.float32)
    centers[..., 2] = rng.uniform(0.7, 1.4, size=(t, 1)).astype(np.float32)
    tris = centers + rng.uniform(-0.25, 0.25, size=(t, 3, 3)).astype(np.float32)
    normals = rng.randn(t, 3, 3).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    colors = rng.uniform(0, 255, size=(t, 3, 3)).astype(np.float32)
    return tris, colors, normals


def tie_scene():
    """Exact z ties: triangles 0 and 1 are the same triangle in different
    colours (every pixel ties; 0 must win), 2 lies in the same z = 1 plane
    overlapping both, 3 is nearer and covers part of all three."""
    base = np.array([[-0.4, -0.4, 1.0], [0.4, -0.3, 1.0], [0.0, 0.45, 1.0]],
                    np.float32)
    other = np.array([[-0.1, -0.5, 1.0], [0.5, 0.1, 1.0], [-0.3, 0.3, 1.0]],
                     np.float32)
    near = np.array([[0.0, -0.2, 0.9], [0.3, 0.0, 0.9], [0.05, 0.25, 0.9]],
                    np.float32)
    tris = np.stack([base, base, other, near])
    normals = np.tile(np.array([0.1, -0.2, -1.0], np.float32), (4, 3, 1))
    colors = np.stack([np.full((3, 3), v, np.float32)
                       for v in (40.0, 200.0, 120.0, 250.0)])
    colors[2, 1] = [10.0, 90.0, 170.0]
    return tris, colors, normals


def scenes():
    """(name, height, width, fov, tris, colors, normals, also_lean_u8)."""
    dense = random_scene(120, 3)
    dense[0][..., 2] = 1.0 + 0.01 * dense[0][..., 2]       # heavy overlap
    return [
        ("square64", 64, 64, 60.0, *random_scene(60, 0), True),
        ("wide96x128", 96, 128, 60.0, *random_scene(60, 1), False),
        ("odd70x100", 70, 100, 45.0, *random_scene(80, 2), True),
        ("dense64", 64, 64, 60.0, *dense, False),
        ("ties64", 64, 64, 60.0, *tie_scene(), False),
    ]


def light_direction():
    light = -np.asarray(LIGHT_DIR, dtype="float32")
    return light / np.linalg.norm(light)


def run_jax_reference(script, job, tmp_dir):
    """Run ``script`` (a test file's ``__main__``) on ``job`` under JAX with
    FMA contraction off; returns its output arrays."""
    job_path, out_path = tmp_dir / "job.npz", tmp_dir / "out.npz"
    np.savez(job_path, **job)
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_cpu_max_isa=AVX").strip()
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join([REPO, env.get("PYTHONPATH", "")])
    res = subprocess.run([sys.executable, script, str(job_path), str(out_path)],
                         env=env, cwd=REPO, capture_output=True, text=True,
                         timeout=900, check=False)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    with np.load(out_path) as out:
        return dict(out)


@pytest.fixture(scope="module")
def jax_frames(tmp_path_factory):
    job = {"light": light_direction()}
    for name, h, w, fov, tris, colors, normals, lean in scenes():
        job[f"{name}/hwf"] = np.array([h, w, fov], np.float32)
        job[f"{name}/tris"], job[f"{name}/colors"] = tris, colors
        job[f"{name}/normals"] = normals
        job[f"{name}/lean"] = np.array(lean)
    return run_jax_reference(os.path.abspath(__file__), job,
                             tmp_path_factory.mktemp("jax_raster"))


def port_frame(h, w, fov, tris, colors, normals, post):
    """The port's frame, binned by the counting sort like every frame; the
    JAX side's ``group=16`` frames take its sort route on these small
    scenes (the same bins)."""
    from cython3dmodelrenderer_tpu_torch.config import RenderConfig
    from cython3dmodelrenderer_tpu_torch.ops.raster import render_frame

    config = RenderConfig(height=h, width=w, fov=fov)
    return render_frame(torch.from_numpy(tris), torch.from_numpy(normals),
                        torch.from_numpy(colors), config, post=post,
                        light=light_direction())


def forbid_sort_route(monkeypatch):
    """Make the sort route (``binsort.bin_pairs``) and B2's wrappers raise
    wherever a module of the frame path holds them."""
    from cython3dmodelrenderer_tpu_torch.ops import binsort, raster, sort

    def sort_route(*_args, **_kwargs):
        raise AssertionError("the frame took the sort route")

    for module, names in ((raster, ("bin_pairs", "sort_i32", "sort_i32_plain")),
                          (binsort, ("bin_pairs", "sort_i32")),
                          (sort, ("sort_i32", "sort_i32_plain"))):
        for name in names:
            monkeypatch.setattr(module, name, sort_route, raising=False)


def bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("scene", scenes(), ids=lambda s: s[0])
def test_gbuffer_bit_equal(jax_frames, scene):
    name, h, w, fov, tris, colors, normals, _lean = scene
    (color, z, normal), img, n_pairs = port_frame(h, w, fov, tris, colors,
                                                  normals, "none")
    assert img is None and n_pairs > 0
    np.testing.assert_array_equal(bits(z.numpy()), bits(jax_frames[f"{name}/z"]))
    np.testing.assert_array_equal(bits(color.numpy()),
                                  bits(jax_frames[f"{name}/color"]))
    np.testing.assert_array_equal(bits(normal.numpy()),
                                  bits(jax_frames[f"{name}/normal"]))
    assert (z.numpy() < 1.0).mean() > 0.05                    # not empty


@pytest.mark.parametrize("scene", scenes(), ids=lambda s: s[0])
def test_lambert_u8_bit_equal(jax_frames, scene):
    name, h, w, fov, tris, colors, normals, _lean = scene
    gbuf, img, _n = port_frame(h, w, fov, tris, colors, normals, "lambert_u8")
    assert gbuf is None and img.dtype == torch.uint8 and img.shape == (h, w, 3)
    np.testing.assert_array_equal(img.numpy(), jax_frames[f"{name}/lambert"])
    assert img.numpy().max() > 0


@pytest.mark.parametrize("scene", [s for s in scenes() if s[-1]],
                         ids=lambda s: s[0])
def test_u8_bit_equal(jax_frames, scene):
    """The hot u8 frame (3 attribute channels on both sides)."""
    name, h, w, fov, tris, colors, normals, _lean = scene
    gbuf, img, _n = port_frame(h, w, fov, tris, colors, normals, "u8")
    assert gbuf is None
    np.testing.assert_array_equal(img.numpy(), jax_frames[f"{name}/u8"])


def test_exact_z_ties_go_to_the_earliest_triangle():
    _name, h, w, fov, tris, colors, normals, _lean = scenes()[-1]
    (color, z, _n), _img, _p = port_frame(h, w, fov, tris, colors, normals,
                                          "none")
    c = color.numpy()[z.numpy()[..., 0] < 1.0]

    def shows(v):      # flat colours interpolate to within float rounding
        return np.abs(c - v).max(axis=-1) < 1e-2

    # triangle 1 (colour 200) duplicates triangle 0 (colour 40): never wins
    assert not shows(200.0).any()
    assert shows(40.0).sum() > 50 and shows(250.0).sum() > 20


def test_wrapper_routes_cpu_tensors_to_plain():
    from cython3dmodelrenderer_tpu_torch.ops import raster
    from cython3dmodelrenderer_tpu_torch.utils.timing import counters

    _name, h, w, fov, tris, colors, normals, _lean = scenes()[0]
    gbuf, img, _ = port_frame(h, w, fov, tris, colors, normals, "lambert_u8")
    gbuf2, img2, _ = port_frame(h, w, fov, tris, colors, normals, "lambert_u8")
    assert torch.equal(img, img2)
    before = counters["launch.raster"]
    from cython3dmodelrenderer_tpu_torch.config import RenderConfig

    out = raster.render_frame(torch.from_numpy(tris), torch.from_numpy(normals),
                              torch.from_numpy(colors),
                              RenderConfig(height=h, width=w, fov=fov),
                              post="lambert_u8", light=light_direction(),
                              backend="cuda")
    assert torch.equal(out[1], img)
    assert counters["launch.raster"] == before      # no kernel on the CPU


#: xy scales of a pose sequence whose pair totals grow and shrink across
#: whole sort tiles at 128 x 160: 3245, 4371, 5802, 3796, 6675, 6283, 3245
CAPACITY_SCALES = (0.5, 0.7, 1.0, 0.6, 2.0, 1.2, 0.5)


def exact_frame(tv, tn, tc, config, light):
    """((gbuf, image), bins, pairs) of a lambert_u8 frame through the plain
    stages with B4 sized exactly by the read pair total."""
    from cython3dmodelrenderer_tpu_torch.ops import binsort, frontend, raster

    rows, tx0, cx, ty0, cy, _counts, total = frontend.frame_planes_plain(
        tv, tn, tc, config, 6, raster.TILE_H, raster.TILE_W)
    ntx = -(-config.width // raster.TILE_W)
    nty = -(-config.height // raster.TILE_H)
    bins = binsort.bin_sort_plain(tx0, cx, ty0, cy, ntx, nty, int(total))
    out = raster.raster_tiles_plain(rows, *bins, ntx, nty, config.height,
                                    config.width, 6, config.z_init,
                                    light=light, gbuffer=True, image=True)
    return out, bins, int(total)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_frames_past_the_capacity_rerun_exactly(monkeypatch, backend):
    """From capacity 0, across poses whose pair totals grow and shrink:
    every frame's G-buffer and image are bit-identical to exact sizing, its
    pair count and active tiles exact; a frame past the capacity counts a
    re-run and raises the capacity to its total in whole sort tiles, any
    other counts a fit; the capacity never drops below the largest total."""
    from cython3dmodelrenderer_tpu_torch.config import RenderConfig
    from cython3dmodelrenderer_tpu_torch.ops import raster
    from cython3dmodelrenderer_tpu_torch.utils.timing import counters

    monkeypatch.setattr(raster, "_CAPACITY", {})
    tris, colors, normals = random_scene(2000, 5)
    tn, tc = torch.from_numpy(normals), torch.from_numpy(colors)
    config = RenderConfig(height=128, width=160, fov=60)
    light = light_direction()
    capacity, largest, reruns = 0, 0, 0
    for scale in CAPACITY_SCALES:
        tv = torch.from_numpy(tris) * torch.tensor([scale, scale, 1.0])
        before = (counters["bins_capacity_fits"],
                  counters["bins_capacity_reruns"])
        stats = {}
        gbuf, img, n = raster.render_frame(tv, tn, tc, config,
                                           post="lambert_u8", light=light,
                                           gbuffer=True, backend=backend,
                                           stats=stats)
        (want_gbuf, want_img), bins, total = exact_frame(tv, tn, tc, config,
                                                         light)
        assert n == total
        assert torch.equal(img, want_img)
        assert all(torch.equal(a, b) for a, b in zip(gbuf, want_gbuf))
        assert int(stats["active_tiles"]) == int((bins[2] > 0).sum())
        rerun = total > capacity
        reruns += rerun
        assert (counters["bins_capacity_fits"] - before[0],
                counters["bins_capacity_reruns"] - before[1]) == (
                    int(not rerun), int(rerun))
        (now,) = raster._CAPACITY.values()
        largest = max(largest, total)
        assert now >= largest and now >= capacity
        assert now == (-(-total // 2048) * 2048 if rerun else capacity)
        capacity = now
    assert reruns == 3 and capacity == 8192


def test_a_sweep_past_the_capacity_reruns_exactly(monkeypatch):
    """A sweep's first view batch from capacity 0 overflows and runs
    again: its frames equal a warm sweep's and ``view_batch=1``'s."""
    from cython3dmodelrenderer_tpu_torch.config import RenderConfig
    from cython3dmodelrenderer_tpu_torch.ops import raster
    from cython3dmodelrenderer_tpu_torch.parallel import multiview
    from cython3dmodelrenderer_tpu_torch.utils.timing import counters

    monkeypatch.setattr(raster, "_CAPACITY", {})
    tris, colors, normals = random_scene(300, 6)
    tv, tn, tc = (torch.from_numpy(a) for a in (tris, normals, colors))
    config = RenderConfig(height=64, width=96, fov=60)
    angles = multiview.turntable_angles(4)

    def sweep(vb):
        return multiview.render_turntable_pallas(tv, tn, tc, angles, config,
                                                 post="u8", view_batch=vb,
                                                 backend="torch")

    reruns = counters["bins_capacity_reruns"]
    cold = sweep(2)
    assert counters["bins_capacity_reruns"] > reruns
    fits = counters["bins_capacity_fits"]
    warm = sweep(2)
    assert counters["bins_capacity_fits"] == fits + 2
    assert int(cold.max()) > 0
    assert torch.equal(cold, warm) and torch.equal(cold, sweep(1))


def test_empty_scene_is_background():
    from cython3dmodelrenderer_tpu_torch.config import RenderConfig
    from cython3dmodelrenderer_tpu_torch.ops.raster import render_frame

    empty = torch.zeros((0, 3, 3))
    config = RenderConfig(height=20, width=40)
    (color, z, normal), img, n = render_frame(empty, empty, empty, config,
                                              post="lambert_u8", gbuffer=True,
                                              light=light_direction())
    assert n == 0 and img.shape == (20, 40, 3) and int(img.max()) == 0
    assert float(z.min()) == 1e6 == float(z.max())
    assert float(color.abs().max()) == 0 == float(normal.abs().max())


def test_sqrt_rn_rounds_correctly():
    """The plain path's square root is the IEEE one (XLA's and the
    kernel's ``__fsqrt_rn``) on a large multi-threaded call too."""
    from cython3dmodelrenderer_tpu_torch.ops.illumination import sqrt_rn

    x = np.random.RandomState(4).rand(1 << 20, 3).astype(np.float32) * 3
    got = sqrt_rn(torch.from_numpy(x)[:, 1])
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.sqrt(x[:, 1]))
    # the float64 root rounded to float32 is the correctly rounded one
    np.testing.assert_array_equal(
        got.numpy(), np.sqrt(x[:, 1].astype(np.float64)).astype(np.float32))


def test_u8_cast_truncates_and_wraps():
    from cython3dmodelrenderer_tpu_torch.ops.illumination import cast_u8

    got = cast_u8(torch.tensor([0.9, 1.0, 254.99, 255.5, 256.0, 300.7, -0.5]))
    assert got.tolist() == [0, 1, 254, 255, 0, 44, 0]


def test_walk_instructions_counts_bbox_pixels():
    """``walk_instructions`` against a pixel-by-pixel count of the pixels
    the kernel's walk visits (each pair's in-image tile pixels inside its
    bbox): two views of a 3 x 2-tile frame with partial edge tiles, random
    bins, random fractional bboxes (some NaN, some past the frame)."""
    from cython3dmodelrenderer_tpu_torch.ops import binning, raster

    ntx, nty, n_views, height, width = 3, 2, 2, 24, 80
    rng = np.random.default_rng(5)
    n_tris = 40
    rows = rng.uniform(-1, 1, (n_tris, binning.row_width(3))).astype(np.float32)
    x0, y0 = rng.uniform(-10, 90, n_tris), rng.uniform(-5, 30, n_tris)
    rows[:, binning.IDX_BBOX:binning.IDX_BBOX + 4] = np.stack(
        [x0, x0 + rng.uniform(0, 40, n_tris), y0,
         y0 + rng.uniform(0, 20, n_tris)], 1)
    rows[3, binning.IDX_BBOX:binning.IDX_BBOX + 4] = np.nan
    counts = rng.integers(0, 6, ntx * nty * n_views).astype(np.int32)
    pair_tri = np.concatenate([np.sort(rng.choice(n_tris, c, replace=False))
                               for c in counts]).astype(np.int32)
    starts = (np.cumsum(counts) - counts).astype(np.int32)
    counts[-1] = 0                                 # an empty bin
    want = 0
    for tile, (s, c) in enumerate(zip(starts, counts)):
        local = tile % (ntx * nty)
        xs = (local % ntx) * raster.TILE_W + np.arange(raster.TILE_W)
        ys = (local // ntx) * raster.TILE_H + np.arange(raster.TILE_H)
        px, py = np.meshgrid(xs[xs < width], ys[ys < height])
        for tri in pair_tri[s:s + c]:
            b = rows[tri, binning.IDX_BBOX:binning.IDX_BBOX + 4]
            box = (px >= b[0]) & (px < b[1]) & (py >= b[2]) & (py < b[3])
            want += raster.INSTR_PER_BBOX_PIXEL * int(box.sum())
    got = raster.walk_instructions(
        torch.from_numpy(rows), torch.from_numpy(pair_tri),
        torch.from_numpy(starts), torch.from_numpy(counts), ntx, nty,
        height, width, n_views)
    assert got == want > 0
    empty = torch.zeros(ntx * nty, dtype=torch.int32)
    assert raster.walk_instructions(torch.from_numpy(rows), empty[:0], empty,
                                    empty, ntx, nty, height, width) == 0


# ---------------------------------------------------------------------------
# JAX reference (run as a script by ``jax_frames``)
# ---------------------------------------------------------------------------

def _jax_main(job_path, out_path):
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from cython3dmodelrenderer_tpu.config import RenderConfig
    from cython3dmodelrenderer_tpu.ops import binning, raster_pallas as rp
    from cython3dmodelrenderer_tpu.ops.projection import (project_to_screen,
                                                          visibility_masks)

    with np.load(job_path) as f:
        job = dict(f)
    light = jnp.asarray(job["light"])
    out = {}
    for key in [k for k in job if k.endswith("/hwf")]:
        name = key[:-4]
        h, w, fov = job[key]
        config = RenderConfig(height=int(h), width=int(w), fov=float(fov))
        tv, tc, tn = (jnp.asarray(job[f"{name}/{k}"])
                      for k in ("tris", "colors", "normals"))
        deg, back = visibility_masks(tv, tn)
        ts = project_to_screen(tv, config)
        slots = int(rp.grouped_slot_total(ts, ~deg & ~back, config, group=16))
        p_cap = binning.capacity_bucket(slots, 128)
        (color, z, normal), _cap, _act, img = rp.render_frame(
            tv, tn, tc, config, p_cap, 0, group=16, interpret=True,
            post="lambert_u8", light=light)
        out.update({f"{name}/color": color, f"{name}/z": z,
                    f"{name}/normal": normal, f"{name}/lambert": img})
        if job[f"{name}/lean"]:
            res = rp.render_frame(tv, tn, tc, config, p_cap, 0, group=16,
                                  interpret=True, post="u8", packed_out=True,
                                  emit_gbuf=False)
            out[f"{name}/u8"] = res[-1]
    np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})


if __name__ == "__main__":
    _jax_main(sys.argv[1], sys.argv[2])
