"""Kernels B1 (raster, single-view and view-batched), B2 (sort), B4
(counting-sort binning), B5 (group-interleaved binning) and the probes P1
(epi_prims) and P2 (vpu_cal) against their plain PyTorch versions, and the
sweep path on both backends.

These need a CUDA device (and nvcc to build ``csrc/``); without one the
``cuda`` fixture skips them (they carry the ``cuda`` marker). On the card
every comparison is exact, except P1's summed primitives, which sum up to
2 x 65,536 floats in another order than torch (rtol 2e-6). Run them there with ``python -m pytest
--noconftest tests/test_torch_kernels_cuda.py`` (the repository's
conftest imports jax).
"""
import numpy as np
import pytest
import torch

from cython3dmodelrenderer_tpu_torch.config import RenderConfig
from cython3dmodelrenderer_tpu_torch.ops import (binning, binsort,
                                                 binsort_grouped, raster)
from cython3dmodelrenderer_tpu_torch.ops.projection import (project_to_screen,
                                                            visibility_masks)
from cython3dmodelrenderer_tpu_torch.ops.sort import sort_i32, sort_i32_plain
from cython3dmodelrenderer_tpu_torch.parallel import multiview
from cython3dmodelrenderer_tpu_torch.probes import epi_prims, vpu_cal
from test_torch_multiview import tiny_scene
from test_torch_raster import light_direction, random_scene

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("n", [1, 2, 1000, 24576, 1 << 15, (1 << 18) + 17])
def test_sort_kernel_matches_torch_sort(cuda, n):
    gen = torch.Generator(device=cuda).manual_seed(n)
    keys = (torch.randperm(4 * n, generator=gen, device=cuda)[:n] * 511
            + 3).to(torch.int32)
    before = sort_i32.launches
    got = sort_i32(keys)
    torch.cuda.synchronize()
    assert torch.equal(got, sort_i32_plain(keys))
    assert sort_i32.launches == before + 1


def binned(cuda, h, w, t, seed, n_attrs):
    tris, colors, normals = random_scene(t, seed)
    cfg = RenderConfig(height=h, width=w, fov=60)
    tv, tn, tc = (torch.from_numpy(a).to(cuda) for a in (tris, normals, colors))
    deg, back = visibility_masks(tv, tn)
    rows, tx0, cx, ty0, cy, counts = binning.plane_data(
        project_to_screen(tv, cfg), ~deg & ~back, cfg, 16, 32, colors=tc,
        normals=tn if n_attrs == 6 else None)
    ntx, nty = -(-w // 32), -(-h // 16)
    pair_tri, starts, tcounts = binsort.bin_pairs(tx0, cx, ty0, cy, ntx, nty,
                                                  int(counts.sum()))
    return dict(rows=rows, pair_tri=pair_tri, tile_starts=starts,
                tile_counts=tcounts, ntx=ntx, nty=nty, height=h, width=w,
                n_attrs=n_attrs, z_init=1e6)


@pytest.mark.parametrize("h,w,t", [(64, 64, 60), (70, 100, 200), (1024, 1024, 3000)])
@pytest.mark.parametrize("post", ["none", "u8", "lambert_u8"])
def test_raster_kernel_matches_plain(cuda, h, w, t, post):
    kw = binned(cuda, h, w, t, t, 3 if post == "u8" else 6)
    light = light_direction() if post == "lambert_u8" else None
    opts = dict(light=light, gbuffer=post == "none", image=post != "none")
    before = raster.raster_tiles.launches
    g_k, i_k = raster.raster_tiles(**kw, **opts)
    g_p, i_p = raster.raster_tiles_plain(**kw, **opts)
    torch.cuda.synchronize()
    assert raster.raster_tiles.launches == before + 1
    if post == "none":
        for a, b in zip(g_k, g_p):
            np.testing.assert_array_equal(a.cpu().numpy().view(np.int32),
                                          b.cpu().numpy().view(np.int32))
    else:
        assert torch.equal(i_k, i_p)


def test_frame_backends_agree(cuda):
    tris, colors, normals = random_scene(400, 11)
    cfg = RenderConfig(height=256, width=192, fov=50)
    args = [torch.from_numpy(a).to(cuda) for a in (tris, normals, colors)]
    for post in ("none", "u8", "lambert_u8"):
        k = raster.render_frame(*args, cfg, post=post, light=light_direction(),
                                backend="cuda", group=16)
        p = raster.render_frame(*args, cfg, post=post, light=light_direction(),
                                backend="torch", group=16)
        assert k[2] == p[2]
        if post == "none":
            assert all(torch.equal(a, b) for a, b in zip(k[0], p[0]))
        else:
            assert torch.equal(k[1], p[1])


def test_ungrouped_frame_backends_agree(cuda):
    """``group=1``: the counting-sort route (B4) on both backends."""
    tris, colors, normals = random_scene(400, 12)
    cfg = RenderConfig(height=256, width=2080, fov=50)     # 65 tiles wide
    args = [torch.from_numpy(a).to(cuda) for a in (tris, normals, colors)]
    for group in (1, 16):
        before = (binsort.bin_sort.launches, sort_i32.launches)
        k = raster.render_frame(*args, cfg, post="lambert_u8", gbuffer=True,
                                light=light_direction(), backend="cuda",
                                group=group)
        p = raster.render_frame(*args, cfg, post="lambert_u8", gbuffer=True,
                                light=light_direction(), backend="torch",
                                group=group)
        torch.cuda.synchronize()
        assert (binsort.bin_sort.launches, sort_i32.launches) == \
            (before[0] + 1, before[1])
        assert k[2] == p[2] > 0
        assert all(torch.equal(a, b) for a, b in zip(k[0], p[0]))
        assert torch.equal(k[1], p[1])


def synthetic_spans(cuda, n_tris, ntx, nty, seed):
    """Tile spans of ``n_tris`` triangles: mostly 1-3 tiles wide, a tenth
    culled, the first 3,000 all on tile 0 (a bin that spans many B4
    blocks), a few whole rows and one triangle over the whole grid."""
    rng = np.random.RandomState(seed)
    tx0, ty0 = rng.randint(0, ntx, n_tris), rng.randint(0, nty, n_tris)
    cx = np.minimum(rng.randint(1, 4, n_tris), ntx - tx0)
    cy = np.minimum(rng.randint(1, 4, n_tris), nty - ty0)
    culled = rng.rand(n_tris) < 0.1
    cx[culled] = cy[culled] = 0
    tx0[:3000] = ty0[:3000] = 0
    cx[:3000] = cy[:3000] = 1
    rows = rng.randint(3000, n_tris, 8)
    tx0[rows], cx[rows], cy[rows] = 0, ntx, 1
    tx0[-1], ty0[-1], cx[-1], cy[-1] = 0, 0, ntx, nty
    spans = [torch.from_numpy(a.astype(np.int32)).to(cuda)
             for a in (tx0, cx, ty0, cy)]
    return (*spans, ntx, nty, int((cx * cy).sum()))


@pytest.mark.parametrize("size", [1024, 2048, 4096, 8192])
def test_bin_sort_kernel_matches_plain(cuda, size):
    spans = synthetic_spans(cuda, 1 << 18, size // 32, size // 16, size)
    before = binsort.bin_sort.launches
    got, again = binsort.bin_sort(*spans), binsort.bin_sort(*spans)
    want = binsort.bin_sort_plain(*spans)
    torch.cuda.synchronize()
    assert binsort.bin_sort.launches == before + 2
    # tile 0's bin is longer than one B4 block's run of triangles
    assert int(want[2][0]) >= 3000 > binsort.block_split(1 << 18,
                                                         size * size // 512)[1]
    for a, b, c in zip(got, again, want):
        assert torch.equal(a, c) and torch.equal(a, b)


@pytest.mark.parametrize("n_live", [0, 1])
def test_bin_sort_kernel_zero_and_one_pair(cuda, n_live):
    live = (torch.arange(4096, device=cuda) < n_live).to(torch.int32)
    spans = (live * 5, live, live * 7, live, 32, 64, n_live)
    got, want = binsort.bin_sort(*spans), binsort.bin_sort_plain(*spans)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got[0].tolist() == [0] * n_live


def batch_inputs(cuda, h, w, n_views, t, seed, n_attrs):
    """The stacked plane rows and bins of an ``n_views`` turntable batch."""
    tv, tn, tc = (torch.from_numpy(a).to(cuda) for a in tiny_scene(t, seed))
    cfg = RenderConfig(height=h, width=w, fov=45)
    angles = multiview.turntable_angles(n_views)
    shifts = np.broadcast_to(np.float32([0.0, 0.0, 1.0]), (n_views, 3))
    rows, tx0, cx, ty0, cy, counts = multiview._stacked_planes(
        tv, tn, tc, angles, shifts, cfg, lean=n_attrs == 3)
    ntx, nty = -(-w // 32), -(-h // 16)
    bins = raster.route_bins(tx0, cx, ty0, cy, ntx, nty, int(counts.sum()),
                             16, "cuda", n_views)
    kw = dict(rows=rows, pair_tri=bins[0], tile_starts=bins[1],
              tile_counts=bins[2], ntx=ntx, nty=nty, height=h, width=w,
              n_attrs=n_attrs, z_init=1e6)
    return kw, (tv, tn, tc, angles, shifts, cfg)


@pytest.mark.parametrize("n_views", [2, 4])
@pytest.mark.parametrize("h,w", [(64, 64), (72, 100), (1024, 1024)])
@pytest.mark.parametrize("post", ["none", "u8", "lambert_u8"])
def test_raster_kernel_view_batch(cuda, n_views, h, w, post):
    """One view-batched B1 launch equals its plain version and a
    single-view launch per view."""
    kw, (tv, tn, tc, angles, shifts, cfg) = batch_inputs(
        cuda, h, w, n_views, 120, n_views, 3 if post == "u8" else 6)
    light = light_direction() if post == "lambert_u8" else None
    opts = dict(light=light, gbuffer=post == "none", image=post != "none")
    before = raster.raster_tiles.launches
    g_k, i_k = raster.raster_tiles(**kw, **opts, n_views=n_views)
    g_p, i_p = raster.raster_tiles_plain(**kw, **opts, n_views=n_views)
    torch.cuda.synchronize()
    assert raster.raster_tiles.launches == before + 1
    got = g_k if post == "none" else (i_k,)
    want = g_p if post == "none" else (i_p,)
    for a, b in zip(got, want):
        assert a.shape[:3] == (n_views, h, w) and torch.equal(a, b)
    for v in range(n_views):
        r1, tx0, cx, ty0, cy, counts = multiview._stacked_planes(
            tv, tn, tc, angles[v:v + 1], shifts[v:v + 1], cfg,
            lean=post == "u8")
        bins = raster.route_bins(tx0, cx, ty0, cy, kw["ntx"], kw["nty"],
                                 int(counts.sum()), 16, "cuda")
        single = raster.raster_tiles(r1, *bins, kw["ntx"], kw["nty"], h, w,
                                     kw["n_attrs"], 1e6, **opts)
        single = single[0] if post == "none" else (single[1],)
        for a, b in zip(got, single):
            assert torch.equal(a[v], b)


@pytest.mark.parametrize("post", ["f32", "u8"])
@pytest.mark.parametrize("fast", [False, True])
def test_sweep_backends_agree(cuda, post, fast):
    """The sweep through the kernels equals the sweep through their plain
    versions, and every view batch equals ``view_batch=1``."""
    tv, tn, tc = (torch.from_numpy(a).to(cuda) for a in tiny_scene(300, 4))
    cfg = RenderConfig(height=200, width=130, fov=45)
    angles = multiview.turntable_angles(4)
    plain = multiview.render_turntable_pallas(tv, tn, tc, angles, cfg,
                                              post=post, fast_shade=fast,
                                              backend="torch")
    for vb in (1, 2, 4):
        before = raster.raster_tiles.launches
        got = multiview.render_turntable_pallas(tv, tn, tc, angles, cfg,
                                                post=post, fast_shade=fast,
                                                view_batch=vb)
        torch.cuda.synchronize()
        assert raster.raster_tiles.launches == before + 4 // vb
        assert torch.equal(got, plain)


def grouped_spans(cuda, size, t, seed):
    tris, colors, normals = random_scene(t, seed)
    cfg = RenderConfig(height=size, width=size, fov=60)
    tv, tn = (torch.from_numpy(a).to(cuda) for a in (tris, normals))
    deg, back = visibility_masks(tv, tn)
    _rows, tx0, cx, ty0, cy, counts = binning.plane_data(
        project_to_screen(tv, cfg), ~deg & ~back, cfg, 16, 32)
    return (tx0, cx, ty0, cy, size // 32, size // 16), int(counts.sum())


@pytest.mark.parametrize("size,t", [(128, 300), (1024, 1000), (2016, 400)])
@pytest.mark.parametrize("cap", ["ample", "half", "tiny"])
def test_bin_sort_grouped_kernel_matches_plain(cuda, size, t, cap):
    spans, total = grouped_spans(cuda, size, t, size)
    plain = binsort_grouped.bin_sort_grouped_plain(*spans, 1 << 16, 16, 8)
    slot_cap = {"ample": min(int(plain[6]), (1 << 17) - 128),
                "half": -(-total // 256) * 128, "tiny": 128}[cap]
    want = binsort_grouped.bin_sort_grouped_plain(*spans, slot_cap, 16, 8)
    before = binsort_grouped.bin_sort_grouped.launches
    got = binsort_grouped.bin_sort_grouped(*spans, slot_cap, 16, 8)
    again = binsort_grouped.bin_sort_grouped(*spans, slot_cap, 16, 8)
    torch.cuda.synchronize()
    assert binsort_grouped.bin_sort_grouped.launches == before + 2
    for a, b, c in zip(got, again, want):
        assert torch.equal(a, c) and torch.equal(a, b)
    placed = int((got[0] != t).sum())
    assert placed <= min(total, slot_cap)
    # a 128-slot cap keeps one group's chunk, whose tiles the first 128
    # pairs in triangle order may all miss
    assert placed > 0 or cap == "tiny"


@pytest.mark.parametrize("n_ops", vpu_cal.N_OPS)
def test_vpu_cal_kernel_matches_plain(cuda, n_ops):
    x = vpu_cal.make_input(8, device=cuda)
    before = vpu_cal.run_once.launches
    got, again = vpu_cal.run_once(x, n_ops), vpu_cal.run_once(x, n_ops)
    want = vpu_cal.run_once_plain(x, n_ops)
    torch.cuda.synchronize()
    assert vpu_cal.run_once.launches == before + 2
    assert torch.equal(got, want) and torch.equal(got, again)
    assert not torch.isnan(got).any()
    assert torch.equal(vpu_cal.run(x, n_ops), vpu_cal.run(x, n_ops, "torch"))


@pytest.mark.parametrize("reps", [0, 2, 5])
@pytest.mark.parametrize("name", epi_prims.ALL_PRIMS)
def test_epi_prims_kernel_matches_plain(cuda, name, reps):
    x, smat = epi_prims.make_input(cuda)
    before = epi_prims.run.launches
    got = epi_prims.run(name, reps, x, smat)
    again = epi_prims.run(name, reps, x, smat)
    want = epi_prims.run_plain(name, reps, x, smat)
    torch.cuda.synchronize()
    assert epi_prims.run.launches == before + 2
    assert torch.equal(got, again)
    if name in epi_prims.ELEMENT_PRIMS or reps == 0:
        assert torch.equal(got, want)
    else:
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=2e-6, atol=0)


def test_epi_prims_refuses_too_much_shared_memory(cuda):
    """A launch asking for more dynamic shared memory than a block may
    have (232,448 bytes on an H100) raises instead of returning zeros."""
    x, smat = epi_prims.make_input(cuda)
    with pytest.raises(RuntimeError, match="failed to launch"):
        epi_prims._launch("epi_cur8", 2, x, smat, smem_bytes=232448 + 4096)
    with pytest.raises(RuntimeError, match="failed to launch"):
        epi_prims._launch("epi_cur8", 2, x, smat, smem_bytes=1024)
