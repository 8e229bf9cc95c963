"""Kernels B1 (raster, single-view and view-batched), B2 (sort) and B4
(counting-sort binning) on the radix-sort core, B5 (group-interleaved
binning), F1 (the frame's front end) and the probes P1 (epi_prims) and P2
(vpu_cal) against their plain PyTorch versions, and the sweep path on both
backends.

These need a CUDA device (and nvcc to build ``csrc/``); without one the
``cuda`` fixture skips them (they carry the ``cuda`` marker). On the card
every comparison is exact (B1's hand-made merge cases and one-tile bins
bit for bit, -0.0 apart from +0.0, and equal on a second call), except
P1's summed primitives, which sum up to 2 x 65,536 floats in another
order than torch (rtol 2e-6). Run them there with ``python -m pytest
--noconftest tests/test_torch_kernels_cuda.py`` (the repository's
conftest imports jax).
"""
import numpy as np
import pytest
import torch

import chip_smoke
from cython3dmodelrenderer_tpu_torch import Model
from cython3dmodelrenderer_tpu_torch.config import RenderConfig
from cython3dmodelrenderer_tpu_torch.ops import (binning, binsort,
                                                 binsort_grouped, frontend,
                                                 raster, sort)
from cython3dmodelrenderer_tpu_torch.ops.projection import (project_to_screen,
                                                            visibility_masks)
from cython3dmodelrenderer_tpu_torch.ops.sort import sort_i32, sort_i32_plain
from cython3dmodelrenderer_tpu_torch.parallel import multiview
from cython3dmodelrenderer_tpu_torch.probes import epi_prims, vpu_cal
from cython3dmodelrenderer_tpu_torch.utils.timing import counters
from test_torch_multiview import tiny_scene
from test_torch_raster import light_direction, random_scene

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


SORT_SIZES = [0, 1, 2, 1000, 17473, 78000, (1 << 17) - 1,
              sort.ONE_LAUNCH_MAX_KEYS, sort.ONE_LAUNCH_MAX_KEYS + 1,
              (1 << 18) + 17]


def sort_keys(cuda, n, width, seed):
    """``n`` keys in [0, 2^width) with runs of duplicates, holding
    2^width - 1 (INT32_MAX at width 31) and 0 when n allows."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    keys = torch.randint(0, 1 << width, (n,), generator=gen, device=cuda,
                         dtype=torch.int64)
    if n:
        keys[::7] = keys[0].clone()
    keys[1::11] = (1 << width) - 1
    keys[2::13] = 0
    return keys.to(torch.int32)


@pytest.mark.parametrize("n", SORT_SIZES)
@pytest.mark.parametrize("width,bits", [(25, 25), (25, 31), (31, 31)])
def test_sort_kernel_matches_torch_sort(cuda, n, width, bits):
    """B2 == torch.sort bit for bit on the keys' own width and on 31 bits,
    on both sides of the one-launch limit, and equal to itself on a second
    call; one launch a call with keys."""
    keys = sort_keys(cuda, n, width, n + bits)
    before = counters["launch.sort"]
    got = sort_i32(keys, bits)
    again = sort_i32(keys, bits)
    torch.cuda.synchronize()
    assert got.shape == keys.shape
    assert n == 0 or got.data_ptr() != keys.data_ptr()
    assert torch.equal(got, sort_i32_plain(keys))
    assert torch.equal(got, again)
    assert counters["launch.sort"] == before + 2 * (n > 0)


@pytest.mark.parametrize("n", [17473, 200000])
def test_sort_kernel_all_keys_equal(cuda, n):
    """One hot digit bucket in every pass, on both paths."""
    keys = torch.full((n,), (1 << 31) - 1, dtype=torch.int32, device=cuda)
    got = sort_i32(keys, 31)
    torch.cuda.synchronize()
    assert torch.equal(got, keys)


def test_core_constants_match_the_planner(cuda):
    """The planner in ``ops/sort.py`` sizes launches with the constants the
    built ``csrc/radix_sort.cu`` uses."""
    assert sort.core_constants() == {
        "radix_bits": sort.RADIX_BITS, "tile_keys": sort.TILE_KEYS,
        "one_launch_max_keys": sort.ONE_LAUNCH_MAX_KEYS,
        "expand_tris": binsort.EXPAND_TRIS, "scan_tiles": binsort.SCAN_TILES}


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
    before = counters["launch.raster"]
    g_k, i_k = raster.raster_tiles(**kw, **opts)
    g_p, i_p = raster.raster_tiles_plain(**kw, **opts)
    torch.cuda.synchronize()
    assert counters["launch.raster"] == before + 1
    if post == "none":
        for a, b in zip(g_k, g_p):
            np.testing.assert_array_equal(a.cpu().numpy().view(np.int32),
                                          b.cpu().numpy().view(np.int32))
    else:
        assert torch.equal(i_k, i_p)


def assert_raster_exact(kw, post):
    """B1 bit-equal to its plain version (-0.0 is not +0.0) and to itself
    on a second call (``chip_smoke.check_raster`` raises otherwise), in
    two launches."""
    before = counters["launch.raster"]
    assert chip_smoke.check_raster("", kw, light_direction(), (post,)) == 0.0
    assert counters["launch.raster"] == before + 2


@pytest.mark.parametrize("n_views,seed", [(1, 0), (1, 1), (2, 2)])
@pytest.mark.parametrize("post", ["none", "u8", "lambert_u8"])
def test_raster_kernel_merge_cases(cuda, n_views, seed, post):
    """Hand-made rows (``chip_smoke.merge_case``): -0.0 and +0.0 winners,
    exact z ties, z exactly 0 and 1, NaN rows, empty and outside bboxes,
    ±inf, huge and fractional bounds, an 80-pixel-wide frame."""
    kw = chip_smoke.merge_case(cuda, n_views, seed)
    assert_raster_exact(kw, post)
    if post == "none":                      # the cases reach the output
        z = raster.raster_tiles(**kw)[0][1]
        assert bool(((z == 0) & torch.signbit(z)).any())
        assert bool(((z == 0) & ~torch.signbit(z)).any())


@pytest.mark.parametrize("n_tris", [1000, 200000])
@pytest.mark.parametrize("post", ["none", "lambert_u8"])
def test_raster_kernel_one_tile(cuda, n_tris, post):
    """One tile holding every candidate (B4's bins), walked by one block."""
    bins = binsort.bin_sort(*chip_smoke.one_tile_spans(n_tris, 32, 64, cuda))
    kw = dict(rows=chip_smoke.one_tile_rows(n_tris, 32, 64, cuda),
              pair_tri=bins[0], tile_starts=bins[1], tile_counts=bins[2],
              ntx=32, nty=64, height=1024, width=1024, n_attrs=6, z_init=1e6)
    assert int(bins[2].max()) == n_tris
    assert_raster_exact(kw, post)


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
        before = (counters["launch.binsort"], counters["launch.sort"])
        k = raster.render_frame(*args, cfg, post="lambert_u8", gbuffer=True,
                                light=light_direction(), backend="cuda",
                                group=group)
        p = raster.render_frame(*args, cfg, post="lambert_u8", gbuffer=True,
                                light=light_direction(), backend="torch",
                                group=group)
        torch.cuda.synchronize()
        assert (counters["launch.binsort"], counters["launch.sort"]) == \
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
    before = counters["launch.binsort"]
    got, again = binsort.bin_sort(*spans), binsort.bin_sort(*spans)
    want = binsort.bin_sort_plain(*spans)
    torch.cuda.synchronize()
    assert counters["launch.binsort"] == before + 2
    # tile 0's bin is longer than one onesweep tile of the sort
    assert int(want[2][0]) >= 3000 > sort.TILE_KEYS
    for a, b, c in zip(got, again, want):
        assert torch.equal(a, c) and torch.equal(a, b)


@pytest.mark.parametrize("n_tris", [1000, sort.ONE_LAUNCH_MAX_KEYS,
                                    sort.ONE_LAUNCH_MAX_KEYS + 1])
def test_bin_sort_kernel_one_tile(cuda, n_tris):
    """Every pair in one tile (one hot digit bucket in every pass), up to
    the one-launch limit and past it; deterministic."""
    ones = torch.ones(n_tris, dtype=torch.int32, device=cuda)
    spans = (ones * 5, ones, ones * 7, ones, 32, 64, n_tris)
    before = counters["launch.binsort"]
    got, again = binsort.bin_sort(*spans), binsort.bin_sort(*spans)
    want = binsort.bin_sort_plain(*spans)
    torch.cuda.synchronize()
    assert counters["launch.binsort"] == before + 2
    for a, b, c in zip(got, again, want):
        assert torch.equal(a, c) and torch.equal(a, b)
    assert int(got[2][7 * 32 + 5]) == n_tris


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
    rows, tx0, cx, ty0, cy, counts, _total = multiview._stacked_planes(
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
    before = counters["launch.raster"]
    g_k, i_k = raster.raster_tiles(**kw, **opts, n_views=n_views)
    g_p, i_p = raster.raster_tiles_plain(**kw, **opts, n_views=n_views)
    torch.cuda.synchronize()
    assert counters["launch.raster"] == before + 1
    got = g_k if post == "none" else (i_k,)
    want = g_p if post == "none" else (i_p,)
    for a, b in zip(got, want):
        assert a.shape[:3] == (n_views, h, w) and torch.equal(a, b)
    for v in range(n_views):
        r1, tx0, cx, ty0, cy, counts, _total = multiview._stacked_planes(
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
        before = counters["launch.raster"]
        got = multiview.render_turntable_pallas(tv, tn, tc, angles, cfg,
                                                post=post, fast_shade=fast,
                                                view_batch=vb)
        torch.cuda.synchronize()
        assert counters["launch.raster"] == before + 4 // vb
        assert torch.equal(got, plain)


def grouped_spans(cuda, size, t, seed):
    tris, colors, normals = random_scene(t, seed)
    cfg = RenderConfig(height=size, width=size, fov=60)
    tv, tn = (torch.from_numpy(a).to(cuda) for a in (tris, normals))
    deg, back = visibility_masks(tv, tn)
    _rows, tx0, cx, ty0, cy, counts = binning.plane_data(
        project_to_screen(tv, cfg), ~deg & ~back, cfg, 16, 32)
    return (tx0, cx, ty0, cy, size // 32, size // 16), int(counts.sum())


def check_grouped(spans, slot_cap, t):
    """B5 at ``slot_cap``: bit-equal to both plain versions in all 8
    outputs and to itself on a second call, B4, B2 (on the 31-bit packed
    tile keys) and the placement launched once a call; returns the number
    of placed slots."""
    want = binsort_grouped.bin_sort_grouped_plain(*spans, slot_cap, 16, 8)
    total = int((spans[1].long() * spans[3]).sum())
    bins = binsort.bin_sort_plain(*spans[:4], spans[4], spans[5], total)
    decomposed = binsort_grouped.place_from_bins_plain(bins, *spans, slot_cap,
                                                       16, 8)
    before = (counters["launch.binsort_grouped"],
              counters["launch.binsort"])
    key_bits = []
    b2 = binsort_grouped.sort_i32

    def recording_sort(keys, bits):
        key_bits.append(bits)
        return b2(keys, bits)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(binsort_grouped, "sort_i32", recording_sort)
        got = binsort_grouped.bin_sort_grouped(*spans, slot_cap, 16, 8)
        again = binsort_grouped.bin_sort_grouped(*spans, slot_cap, 16, 8)
    torch.cuda.synchronize()
    assert counters["launch.binsort_grouped"] == before[0] + 2
    assert counters["launch.binsort"] == before[1] + 2
    assert key_bits == [binsort_grouped.TRI_BITS + binsort_grouped.TILE_BITS] * 2
    for a, b, c, d in zip(got, again, want, decomposed):
        assert a.dtype == c.dtype and a.shape == c.shape
        assert torch.equal(a, c) and torch.equal(a, b) and torch.equal(a, d)
    placed = int((got[0] != t).sum())
    assert placed <= min(total, slot_cap)
    return placed


@pytest.mark.parametrize("size,t", [(128, 300), (1024, 1000), (2016, 400)])
@pytest.mark.parametrize("cap", ["ample", "half", "tiny", "mid_span"])
def test_bin_sort_grouped_kernel_matches_plain(cuda, size, t, cap):
    spans, total = grouped_spans(cuda, size, t, size)
    plain = binsort_grouped.bin_sort_grouped_plain(*spans, 1 << 16, 16, 8)
    slot_cap = {"ample": min(int(plain[6]), (1 << 17) - 128),
                "half": -(-total // 256) * 128, "tiny": 128,
                "mid_span": chip_smoke.mid_span_cap(spans[1], spans[3])}[cap]
    placed = check_grouped(spans, slot_cap, t)
    # a 128-slot cap keeps one group's chunk, whose tiles the first 128
    # pairs in triangle order may all miss
    assert placed > 0 or cap == "tiny"


@pytest.mark.parametrize("slot_cap", [128, 4096, (1 << 17) - 128])
def test_bin_sort_grouped_kernel_one_tile(cuda, slot_cap):
    """2^17 - 1 triangles, every pair in one tile: one bin of 131,071
    ranks, cut at a triangle's first pair (each span is one tile)."""
    t = (1 << 17) - 1
    spans = chip_smoke.one_tile_spans(t, 32, 64, cuda)[:6]
    placed = check_grouped(spans, slot_cap, t)
    assert 0 < placed <= slot_cap


@pytest.mark.parametrize("n_ops", vpu_cal.N_OPS)
def test_vpu_cal_kernel_matches_plain(cuda, n_ops):
    x = vpu_cal.make_input(8, device=cuda)
    before = counters["launch.vpu_cal"]
    got, again = vpu_cal.run_once(x, n_ops), vpu_cal.run_once(x, n_ops)
    want = vpu_cal.run_once_plain(x, n_ops)
    torch.cuda.synchronize()
    assert counters["launch.vpu_cal"] == before + 2
    assert torch.equal(got, want) and torch.equal(got, again)
    assert not torch.isnan(got).any()
    assert torch.equal(vpu_cal.run(x, n_ops), vpu_cal.run(x, n_ops, "torch"))


@pytest.mark.parametrize("reps", [0, 2, 5, 128, 129])
@pytest.mark.parametrize("name", epi_prims.ALL_PRIMS)
def test_epi_prims_kernel_matches_plain(cuda, name, reps):
    x, smat = epi_prims.make_input(cuda)
    before = counters["launch.epi_prims"]
    got = epi_prims.run(name, reps, x, smat)
    again = epi_prims.run(name, reps, x, smat)
    want = epi_prims.run_plain(name, reps, x, smat)
    torch.cuda.synchronize()
    assert counters["launch.epi_prims"] == before + 2 * (reps > 0)
    assert torch.equal(got, again)
    exact = name in epi_prims.ELEMENT_PRIMS
    if exact or reps == 0:
        assert torch.equal(got, want)
    elif reps <= 5:
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=2e-6, atol=0)
    # every replica sees the same tile, so R replicas are R f32 adds of the
    # one-replica value on each side (R x 2^-24 apart at most when the two
    # one-replica values differ): the kernel's grid must not change a bit
    for run, value in ((epi_prims.run, got), (epi_prims.run_plain, want)):
        one = np.float32(run(name, 1, x, smat).item())
        fold = np.float32(0.0)
        for _ in range(reps):
            fold = np.float32(fold + one)
        assert value.item() == fold
    one_k = epi_prims.run(name, 1, x, smat).item()
    one_p = epi_prims.run_plain(name, 1, x, smat).item()
    assert one_k == one_p if exact else abs(one_k - one_p) <= 2e-6 * abs(one_p)


def test_epi_prims_refuses_too_much_shared_memory(cuda):
    """A launch asking for more dynamic shared memory than a block may
    have (232,448 bytes on an H100) raises instead of returning zeros."""
    x, smat = epi_prims.make_input(cuda)
    with pytest.raises(RuntimeError, match="failed to launch"):
        epi_prims._launch("epi_cur8", 2, x, smat, smem_bytes=232448 + 4096)
    with pytest.raises(RuntimeError, match="failed to launch"):
        epi_prims._launch("epi_cur8", 2, x, smat, smem_bytes=1024)


def frontend_scene(cuda, name):
    """(vertices, normals, colours, height, width, poses) of an F1 case:
    ``n<T>`` is the first T triangles of the edge scene at 1024²,
    ``posed<T>`` T of them posed in 3 views (T not a multiple of the
    block: blocks cross view boundaries, T = 45 twice in one block)."""
    if name.startswith(("n", "posed")):
        t = int(name.removeprefix("posed").removeprefix("n"))
        arrays = tuple(a[:t] for a in chip_smoke.frontend_edge_scene(
            cuda, n=max(t, 6)))
        poses = chip_smoke.sweep_poses(3) if name.startswith("posed") else None
        return (*arrays, 1024, 1024, poses)
    if name.startswith("edge"):
        arrays = chip_smoke.frontend_edge_scene(cuda)
        if name == "edge_posed":
            return (*arrays, 1024, 1024, chip_smoke.sweep_poses(3))
        return (*arrays, 72, 100, None) if name == "edge72x100" else (
            *arrays, 1024, 1024, None)
    if name == "empty":
        return (*(torch.zeros((0, 3, 3), device=cuda) for _ in range(3)),
                64, 64, None)
    make = (chip_smoke.displaced_sphere(chip_smoke.TRI_SPHERE_SEGMENTS,
                                        chip_smoke.TRI_SPHERE_RINGS)
            if name == "sphere16k"
            else chip_smoke.displaced_torus(*chip_smoke.TORUS_QUADS))
    model = chip_smoke.posed(Model(*make, device=cuda), True)
    return (model.vertices_by_triangles, model.normals_by_triangles,
            chip_smoke.seeded_colors(model), 1024, 1024, None)


def frontend_args(scene_arrays, n_attrs, fast):
    tv, tn, tc, h, w, poses = scene_arrays
    cfg = RenderConfig(height=h, width=w, fov=chip_smoke.FOV)
    return ((tv, tn, tc, cfg, n_attrs, raster.TILE_H, raster.TILE_W),
            dict(shade=light_direction() if fast else None, poses=poses))


@pytest.mark.parametrize("variant", chip_smoke.FRONTEND_VARIANTS,
                         ids=lambda v: v[0])
@pytest.mark.parametrize("scene", ["edge1024", "edge72x100", "edge_posed",
                                   "empty", "sphere16k", "torus262k"]
                         + [f"n{t}" for t in chip_smoke.FRONTEND_COUNTS]
                         + ["posed45", "posed200"])
def test_frontend_kernel_matches_plain(cuda, scene, variant):
    """F1 equals its plain version bit for bit in every output (NaN bits
    included) and itself on a second call; one launch a call, also with
    no triangles (it writes the zero total)."""
    _tag, n_attrs, fast = variant
    args, kwargs = frontend_args(frontend_scene(cuda, scene), n_attrs, fast)
    before = counters["launch.frontend"]
    got = frontend.frame_planes(*args, **kwargs)
    again = frontend.frame_planes(*args, **kwargs)
    want = frontend.frame_planes_plain(*args, **kwargs)
    torch.cuda.synchronize()
    assert counters["launch.frontend"] == before + 2
    assert got[0].is_contiguous()
    for a, b, c in zip(got, again, want):
        assert a.device.type == "cuda"
        assert chip_smoke.same_bits(a, c) and chip_smoke.same_bits(a, b)


def test_frontend_totals_alternate_exactly(cuda):
    """Calls with different pair totals, no triangles among them, queued
    back to back on one stream: each total is exact, so every launch's
    last block left the accumulator and the ticket at zero."""
    cases = [frontend_scene(cuda, name) for name in
             ("sphere16k", "empty", "n129", "edge72x100", "empty", "n1",
              "posed45", "sphere16k")]
    calls = [frontend_args(arrays, 6, False) for arrays in cases]
    got = [frontend.frame_planes(*a, **kw)[-1] for a, kw in calls]
    want = [int(frontend.frame_planes_plain(*a, **kw)[-1]) for a, kw in calls]
    assert [int(t) for t in got] == want
    assert len(set(want)) >= 4 and want[1] == want[4] == 0


@pytest.mark.parametrize("variant", chip_smoke.FRONTEND_VARIANTS,
                         ids=lambda v: v[0])
def test_frontend_misaligned_inputs(cuda, variant):
    """Inputs that are views at a 4-byte offset (no 16-byte alignment)
    give the plain version's bits."""
    _tag, n_attrs, fast = variant
    tv, tn, tc, h, w, _poses = frontend_scene(cuda, "n259")

    def shifted(a):
        buf = torch.empty(a.numel() + 1, device=cuda)
        buf[1:] = a.reshape(-1)
        return buf[1:].view(a.shape)

    args, kwargs = frontend_args((tv, tn, tc, h, w, chip_smoke.sweep_poses(3)),
                                 n_attrs, fast)
    moved = (shifted(tv), shifted(tn), shifted(tc)) + args[3:]
    assert moved[0].data_ptr() % 16 == 4
    want = frontend.frame_planes_plain(*args, **kwargs)
    got = frontend.frame_planes(*moved, **kwargs)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert chip_smoke.same_bits(a, b)


@pytest.mark.parametrize("n_attrs", [0, 3, 6])
def test_frontend_constants_match_the_plan(cuda, n_attrs):
    """``frontend.frontend_plan`` sizes launches with the block and the
    shared memory the built kernel has."""
    got = frontend.kernel_constants(n_attrs)
    plan = frontend.frontend_plan(16128, n_attrs)
    assert got["threads"] == plan.threads
    assert got["smem_bytes"] == plan.smem_bytes


def test_frontend_render_frame_launches_once(cuda):
    """A frame on the cuda backend launches F1 once and B1 once."""
    tris, colors, normals = random_scene(400, 13)
    cfg = RenderConfig(height=256, width=192, fov=50)
    args = [torch.from_numpy(a).to(cuda) for a in (tris, normals, colors)]
    before = (counters["launch.frontend"], counters["launch.raster"])
    raster.render_frame(*args, cfg, post="lambert_u8", light=light_direction(),
                        backend="cuda", group=16)
    torch.cuda.synchronize()
    assert (counters["launch.frontend"], counters["launch.raster"]) == (
        before[0] + 1, before[1] + 1)
