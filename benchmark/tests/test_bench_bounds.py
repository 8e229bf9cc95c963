"""The frozen bound arithmetic against hand counts, and the reference's
stats against the program's own counts of the same frame (CPU)."""
import numpy as np
import pytest
import torch

from reference import bounds, meshes, render

HBM, F32 = 3.35e12, 33.5e12


def test_f1_hand_count():
    # 100 triangles at 6 channels: 3 x 36 bytes in, a 34-float row and five
    # int32 spans out: 264 bytes a triangle, and the 8-byte total
    assert bounds.f1(100, 1, 6, posed=False) == pytest.approx(
        max((100 * 264 + 8) / HBM, 100 * 310 / F32))
    # a posed batch of 4 views at 3 channels: poses 48 B a view, rows of
    # 25 floats
    n = 4 * 10
    assert bounds.f1(10, 4, 3, posed=True) == pytest.approx(
        max((10 * 108 + 4 * 48 + n * (100 + 20) + 8) / HBM,
            n * (220 + 45 + 99) / F32))


def test_raster_hand_count():
    # 64 x 32 image: 2 x 2 tiles; 10 rows of 25 floats, 5 pairs, the
    # tables, the u8 image; 28 instructions for each of 100 window pixels
    read = 10 * 100 + 5 * 4 + 4 * 8
    assert bounds.raster(10, 1, 5, 100, 3, 32, 64) == pytest.approx(
        max((read + 64 * 32 * 3) / HBM, 2800 / F32))


def test_binning_routes_and_counts():
    assert bounds.sort_route(16128, 1, 17473, 1024, 1024)
    assert not bounds.sort_route(16128, 8, 140000, 1024, 1024)  # 2^14 tiles
    assert not bounds.sort_route(262144, 1, 161209, 1024, 1024)
    assert not bounds.sort_route(16128, 1, 44409, 2048, 2048)  # 64 across
    # sort route: 14 triangle bits + 11 tile bits = 25 -> 4 passes
    assert bounds.binning(16128, 1, 17473, 1024, 1024) == pytest.approx(
        max(8 * 17473 / HBM, 2 * 17473 * 4 / F32))
    # counting route: 4 span arrays in, pairs and two tables out
    n_tiles = 8 * 32 * 64
    assert bounds.binning(16128, 8, 140000, 1024, 1024) == pytest.approx(
        max((16 * 8 * 16128 + 4 * 140000 + 8 * n_tiles) / HBM,
            2 * 140000 / F32))


@pytest.mark.parametrize("lit", [False, True])
def test_stats_match_the_program_counts(lit):
    """The reference's pairs and window pixels equal the program's pair
    total and B1's walk (ops/raster.py::walk_instructions / 28) on the
    plain path."""
    from cython3dmodelrenderer_tpu_torch import RenderConfig
    from cython3dmodelrenderer_tpu_torch.ops import binsort, frontend, raster

    vertices, faces = meshes.displaced_torus(48, 24)
    pose = {"rotations": [[-90, 180, 0], [10, -80, 0]], "shift": [0, 0, 2]}
    colors = meshes.seeded_colors(len(vertices), np.random.default_rng(5))
    (s,) = meshes.posed_states(vertices, faces, pose, [33.0], colors)
    cam = {"width": 200, "height": 150, "fov": 45.0, "z_near": 0.1,
           "z_far": 1000.0}
    t = {k: torch.from_numpy(np.ascontiguousarray(s[k]))
         for k in ("vertices", "faces_v", "normals", "colors")}
    light = render.frame_light([0, 0, 1]) if lit else None
    _img, stats = render.render_view(t["vertices"], t["faces_v"], t["normals"],
                                     t["colors"], cam, light=light)
    f = t["faces_v"].long()
    config = RenderConfig(height=150, width=200, fov=45.0)
    rows, tx0, cx, ty0, cy, _c, total = frontend.frame_planes_plain(
        t["vertices"][f], t["normals"][f], t["colors"][f], config,
        6 if lit else 3, raster.TILE_H, raster.TILE_W)
    ntx, nty = -(-200 // raster.TILE_W), -(-150 // raster.TILE_H)
    bins = binsort.bin_sort_plain(tx0, cx, ty0, cy, ntx, nty, int(total))
    assert stats["pairs"] == int(total) > 0
    walk = raster.walk_instructions(rows, *bins, ntx, nty, 150, 200)
    assert stats["window_pixels"] * bounds.RASTER_INSTR_PER_PIXEL == walk
