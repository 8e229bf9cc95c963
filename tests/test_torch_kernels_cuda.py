"""Kernels B1 (raster, single-view and view-batched), B2 (sort) and B4
(counting-sort binning) on the radix-sort core, B5 (group-interleaved
binning), F1 (the frame's front end) and the probes P1 (epi_prims) and P2
(vpu_cal) against their plain PyTorch versions, the sweep path on both
backends, and the untextured frame's fallback colours (the pinned copy
without a synchronisation).

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
import cython3dmodelrenderer_tpu_torch as pt
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
                                backend="cuda")
        p = raster.render_frame(*args, cfg, post=post, light=light_direction(),
                                backend="torch")
        assert k[2] == p[2]
        if post == "none":
            assert all(torch.equal(a, b) for a, b in zip(k[0], p[0]))
        else:
            assert torch.equal(k[1], p[1])


def test_ungrouped_frame_backends_agree(cuda):
    """A warm frame (B4's capacity holds its pairs) past JAX's grouped
    budget (65 tiles wide): the counting-sort route (B4) on both
    backends."""
    tris, colors, normals = random_scene(400, 12)
    cfg = RenderConfig(height=256, width=2080, fov=50)     # 65 tiles wide
    args = [torch.from_numpy(a).to(cuda) for a in (tris, normals, colors)]

    def frame(backend):
        return raster.render_frame(*args, cfg, post="lambert_u8", gbuffer=True,
                                   light=light_direction(), backend=backend)

    frame("cuda")                                       # warm
    before = (counters["launch.binsort"], counters["launch.sort"])
    k = frame("cuda")
    p = frame("torch")
    torch.cuda.synchronize()
    assert (counters["launch.binsort"], counters["launch.sort"]) == \
        (before[0] + 1, before[1])
    assert k[2] == p[2] > 0
    assert all(torch.equal(a, b) for a, b in zip(k[0], p[0]))
    assert torch.equal(k[1], p[1])


@pytest.mark.parametrize("post", ["u8", "lambert_u8"])
def test_frame_inside_the_grouped_budget_takes_b4(cuda, post):
    """A warm frame inside JAX's grouped budget (at ``group=16``), which
    took the sort route before: one B4 launch and no B2, bit-equal to the
    plain backend and to B1 over ``bin_pairs``' bins on the card (the old
    route: B2 and its glue)."""
    tris, colors, normals = random_scene(200, 21)
    cfg = RenderConfig(height=1024, width=1024, fov=60)
    args = [torch.from_numpy(a).to(cuda) for a in (tris, normals, colors)]
    light = light_direction()
    raster.render_frame(*args, cfg, post=post, light=light, backend="cuda")
    before = (counters["launch.binsort"], counters["launch.sort"])
    _g, img, total = raster.render_frame(*args, cfg, post=post, light=light,
                                         backend="cuda")
    torch.cuda.synchronize()
    assert (counters["launch.binsort"], counters["launch.sort"]) == \
        (before[0] + 1, before[1])
    assert binsort.grouped_limits_ok(len(tris), total, 32, 64), total
    _g, plain, plain_total = raster.render_frame(
        *args, cfg, post=post, light=light, backend="torch")
    assert total == plain_total > 0 and torch.equal(img, plain)
    n_attrs = 3 if post == "u8" else 6
    rows, tx0, cx, ty0, cy, _counts, _t = frontend.frame_planes(
        *args, cfg, n_attrs, raster.TILE_H, raster.TILE_W)
    old_bins = binsort.bin_pairs(tx0, cx, ty0, cy, 32, 64, total)
    _g, old = raster.raster_tiles(
        rows, *old_bins, 32, 64, 1024, 1024, n_attrs, cfg.z_init,
        light=light if post == "lambert_u8" else None, gbuffer=False,
        image=True)
    torch.cuda.synchronize()
    assert counters["launch.sort"] == before[1] + 1
    assert torch.equal(img, old) and int(img.max()) > 0


@pytest.mark.parametrize("lit", [False, True])
def test_view_batch_inside_the_grouped_budget_takes_b4(cuda, lit):
    """A warm 2-view u8 batch through ``_render_view_batch`` inside JAX's
    grouped budget: one B4 launch and no B2, bit-equal to the plain
    backend and to B1 over ``bin_pairs``' bins of the stacked spans."""
    tv, tn, tc = (torch.from_numpy(a).to(cuda) for a in tiny_scene(300, 4))
    cfg = RenderConfig(height=1024, width=1024, fov=45)
    angles = multiview.turntable_angles(2)
    shifts = np.broadcast_to(np.float32([0.0, 0.0, 1.0]), (2, 3))
    light = multiview._norm_light((0.0, 0.0, 1.0)) if lit else None
    batch = (tv, tn, tc, angles, shifts, cfg, light, False, "u8")
    multiview._render_view_batch(*batch, "cuda")        # warm
    before = (counters["launch.binsort"], counters["launch.sort"])
    img, total = multiview._render_view_batch(*batch, "cuda")
    torch.cuda.synchronize()
    assert (counters["launch.binsort"], counters["launch.sort"]) == \
        (before[0] + 1, before[1])
    assert binsort.grouped_limits_ok(2 * len(tv), total, 32,
                                     2 * raster.view_row_stride(64, 16))
    plain, plain_total = multiview._render_view_batch(*batch, "torch")
    assert total == plain_total > 0 and torch.equal(img, plain)
    n_attrs = 6 if lit else 3
    rows, tx0, cx, ty0, cy, _counts, _t = multiview._stacked_planes(
        tv, tn, tc, angles, shifts, cfg, n_attrs)
    old_bins = binsort.bin_pairs(tx0, cx, ty0, cy, 32, 2 * 64, total)
    _g, old = raster.raster_tiles(rows, *old_bins, 32, 64, 1024, 1024,
                                  n_attrs, cfg.z_init, light=light,
                                  gbuffer=False, image=True, n_views=2)
    torch.cuda.synchronize()
    assert torch.equal(img, old) and int(img.max()) > 0


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


#: a word no B4 launch writes, and the canary words after each buffer
CANARY = -0x2A2A2A2B
CANARY_WORDS = 4096
#: (triangles, capacity or None for the pairs rounded up to whole sort
#: tiles plus one tile) at 1024²: ~20k pairs on the one launch, ~440k on
#: onesweep, and ~110k pairs at a capacity past the one-launch limit
CAPACITY_CASES = {"one_launch": (8000, None), "onesweep": (128000, None),
                  "crossing": (30000, 200000)}


def capacity_spans(cuda, case):
    """(spans, total, capacity) of a ``CAPACITY_CASES`` case."""
    n_tris, capacity = CAPACITY_CASES[case]
    spans = synthetic_spans(cuda, n_tris, 32, 64, n_tris)
    total = spans[-1]
    if capacity is None:
        capacity = -(-total // sort.TILE_KEYS) * sort.TILE_KEYS + sort.TILE_KEYS
    return spans, total, capacity


def bin_sort_canaried(spans, total, capacity):
    """B4 through its C launcher as ``binsort.bin_sort`` calls it with a
    device total, on buffers ``CANARY_WORDS`` longer than its plan, all
    filled with ``CANARY``: (pair_tri, scratch, work, plan's scratch
    words), after the call."""
    tx0, cx, ty0, cy, ntx, nty = spans[:6]
    dev, n_tiles = tx0.device, ntx * nty
    plan = binsort.bin_sort_plan(tx0.shape[0], n_tiles, capacity)

    def buf(n):
        return torch.full((n + CANARY_WORDS,), CANARY, dtype=torch.int32,
                          device=dev)

    pair_tri, scratch, work = (buf(capacity), buf(plan.scratch_words),
                               buf(3 * capacity))
    total_t = torch.tensor(total, dtype=torch.int64, device=dev)
    lib = sort._lib()
    err = lib.binsort_launch(
        *(t.data_ptr() for t in (tx0, cx, ty0, cy)), tx0.shape[0], ntx,
        n_tiles, total_t.data_ptr(), capacity, binsort.tile_bits(n_tiles),
        scratch.data_ptr(), work.data_ptr(), pair_tri.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    assert err == 0
    torch.cuda.synchronize()
    return pair_tri, scratch, work, plan.scratch_words


def is_canary(t):
    return bool((t == CANARY).all())


@pytest.mark.parametrize("case", sorted(CAPACITY_CASES))
def test_bin_sort_kernel_at_a_capacity(cuda, case):
    """B4 sized for a capacity above its device total equals the exactly
    sized B4 bit for bit (pair_tri's first ``total`` ids, the starts and
    counts) on the one launch, on onesweep and across the route limit
    (the exact call takes the one launch, the capacity onesweep); it
    writes no pair id past the total and no word past its buffers. With a
    capacity the total must be an int64 on the card."""
    spans, total, capacity = capacity_spans(cuda, case)
    exact_plan = binsort.bin_sort_plan(spans[0].shape[0], 2048, total)
    plan = binsort.bin_sort_plan(spans[0].shape[0], 2048, capacity)
    assert plan.sort.one_launch == (case == "one_launch")
    assert exact_plan.sort.one_launch == (case != "onesweep")
    assert total < capacity and (case != "onesweep" or total > 400000)
    want = binsort.bin_sort(*spans)
    total_t = torch.tensor(total, dtype=torch.int64, device=cuda)
    before = counters["launch.binsort"]
    got = binsort.bin_sort(*spans[:6], total_t, capacity)
    again = binsort.bin_sort(*spans[:6], total_t, capacity)
    torch.cuda.synchronize()
    assert counters["launch.binsort"] == before + 2
    assert got[0].shape == (capacity,)
    for out in (got, again):
        assert torch.equal(out[0][:total], want[0])
        assert torch.equal(out[1], want[1]) and torch.equal(out[2], want[2])
    pair_tri, scratch, work, words = bin_sort_canaried(spans, total, capacity)
    assert torch.equal(pair_tri[:total], want[0]) and is_canary(pair_tri[total:])
    assert is_canary(scratch[words:]) and is_canary(work[3 * capacity:])
    assert torch.equal(scratch[:2048], want[1])
    for bad in (total, total_t.cpu(), total_t.to(torch.int32)):
        with pytest.raises(ValueError, match="one int64"):
            binsort.bin_sort(*spans[:6], bad, capacity)


@pytest.mark.parametrize("case", sorted(CAPACITY_CASES))
def test_bin_sort_kernel_overflow_writes_nothing(cuda, case):
    """A device total past the capacity (half the total, in whole sort
    tiles) is an overflow: empty bins, not an error; no pair id or work
    word is written, nor any word past the scratch's plan; B1 on those
    bins writes the background."""
    spans, total, _capacity = capacity_spans(cuda, case)
    capacity = total // 2 // sort.TILE_KEYS * sort.TILE_KEYS
    assert 0 < capacity < total
    pair_tri, scratch, work, words = bin_sort_canaried(spans, total, capacity)
    assert is_canary(pair_tri) and is_canary(work)
    assert int(scratch[:2 * 2048].abs().sum()) == 0
    assert is_canary(scratch[words:])
    bins = binsort.bin_sort(*spans[:6], torch.tensor(total, device=cuda),
                            capacity)
    assert bins[0].shape == (capacity,) and int(bins[2].abs().sum()) == 0
    rows = torch.zeros((spans[0].shape[0], binning.row_width(3)),
                       dtype=torch.float32, device=cuda)
    gbuf, img = raster.raster_tiles(rows, *bins, 32, 64, 1024, 1024, 3, 1e6,
                                    image=True)
    torch.cuda.synchronize()
    assert int(img.abs().amax()) == 0 and bool((gbuf[1] == 1e6).all())


def test_frames_rerun_exactly_on_the_card(cuda, monkeypatch):
    """The CPU test's pose sequence on the kernels, from capacity 0: each
    frame bit-identical to the plain stages sized exactly, three re-runs
    and four fits counted, and the second pass all fits."""
    from test_torch_raster import CAPACITY_SCALES, exact_frame

    monkeypatch.setattr(raster, "_CAPACITY", {})
    tris, colors, normals = random_scene(2000, 5)
    tn, tc = (torch.from_numpy(a).to(cuda) for a in (normals, colors))
    config = RenderConfig(height=128, width=160, fov=60)
    light = light_direction()
    start = (counters["bins_capacity_fits"], counters["bins_capacity_reruns"])
    for sweep in range(2):
        for scale in CAPACITY_SCALES:
            tv = torch.from_numpy(tris).to(cuda) * torch.tensor(
                [scale, scale, 1.0], device=cuda)
            gbuf, img, n = raster.render_frame(
                tv, tn, tc, config, post="lambert_u8", light=light,
                gbuffer=True, backend="cuda")
            (want_gbuf, want_img), _bins, total = exact_frame(tv, tn, tc,
                                                              config, light)
            assert n == total and torch.equal(img, want_img)
            assert all(torch.equal(a, b) for a, b in zip(gbuf, want_gbuf))
        assert (counters["bins_capacity_fits"] - start[0],
                counters["bins_capacity_reruns"] - start[1]) == (
                    (4, 3) if sweep == 0 else (11, 3))
    assert list(raster._CAPACITY.values()) == [8192]


def batch_inputs(cuda, h, w, n_views, t, seed, n_attrs):
    """The stacked plane rows and bins of an ``n_views`` turntable batch."""
    tv, tn, tc = (torch.from_numpy(a).to(cuda) for a in tiny_scene(t, seed))
    cfg = RenderConfig(height=h, width=w, fov=45)
    angles = multiview.turntable_angles(n_views)
    shifts = np.broadcast_to(np.float32([0.0, 0.0, 1.0]), (n_views, 3))
    rows, tx0, cx, ty0, cy, counts, _total = multiview._stacked_planes(
        tv, tn, tc, angles, shifts, cfg, n_attrs)
    ntx, nty = -(-w // 32), -(-h // 16)
    bins = raster.route_bins(tx0, cx, ty0, cy, ntx, nty, int(counts.sum()),
                             "cuda", n_views)
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
            tv, tn, tc, angles[v:v + 1], shifts[v:v + 1], cfg, kw["n_attrs"])
        bins = raster.route_bins(tx0, cx, ty0, cy, kw["ntx"], kw["nty"],
                                 int(counts.sum()), "cuda")
        single = raster.raster_tiles(r1, *bins, kw["ntx"], kw["nty"], h, w,
                                     kw["n_attrs"], 1e6, **opts)
        single = single[0] if post == "none" else (single[1],)
        for a, b in zip(got, single):
            assert torch.equal(a[v], b)


@pytest.mark.parametrize("post", ["f32", "u8"])
@pytest.mark.parametrize("fast", [False, True])
def test_sweep_backends_agree(cuda, post, fast):
    """The sweep through the kernels equals the sweep through their plain
    versions, and every view batch equals ``view_batch=1``; B1 launches
    once a batch, and once more for a batch that overflowed B4's
    capacity."""
    tv, tn, tc = (torch.from_numpy(a).to(cuda) for a in tiny_scene(300, 4))
    cfg = RenderConfig(height=200, width=130, fov=45)
    angles = multiview.turntable_angles(4)
    plain = multiview.render_turntable_pallas(tv, tn, tc, angles, cfg,
                                              post=post, fast_shade=fast,
                                              backend="torch")
    for vb in (1, 2, 4):
        before = (counters["launch.raster"],
                  counters["bins_capacity_reruns"])
        got = multiview.render_turntable_pallas(tv, tn, tc, angles, cfg,
                                                post=post, fast_shade=fast,
                                                view_batch=vb)
        torch.cuda.synchronize()
        assert counters["launch.raster"] == before[0] + 4 // vb + (
            counters["bins_capacity_reruns"] - before[1])
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
    """A warm frame (B4's capacity holds its pairs) on the cuda backend
    launches F1 once and B1 once."""
    tris, colors, normals = random_scene(400, 13)
    cfg = RenderConfig(height=256, width=192, fov=50)
    args = [torch.from_numpy(a).to(cuda) for a in (tris, normals, colors)]

    def frame():
        raster.render_frame(*args, cfg, post="lambert_u8",
                            light=light_direction(), backend="cuda")

    frame()                                             # warm
    before = (counters["launch.frontend"], counters["launch.raster"])
    frame()
    torch.cuda.synchronize()
    assert (counters["launch.frontend"], counters["launch.raster"]) == (
        before[0] + 1, before[1] + 1)


def test_textured_frames_gather_colours_once(cuda):
    """Two lit 1024² frames of a textured model on the card gather its
    triangle colours once (``colors_gathered``) and give identical images,
    equal to the frame of a fresh gather handed to ``render_arrays``."""
    model = chip_smoke.textured(chip_smoke.posed(Model(
        *chip_smoke.displaced_sphere(chip_smoke.TRI_SPHERE_SEGMENTS,
                                     chip_smoke.TRI_SPHERE_RINGS),
        device=cuda), True))
    shader = pt.GuroIllumination([0, 0, 1])
    filler = pt.AdvancedPixelBufferFiller(1024, 1024, fov=chip_smoke.FOV,
                                          device=cuda)
    renderer = pt.Renderer(filler, shader, pt.SimpleIterator, 1024, 1024)
    before = counters["colors_gathered"]
    images = [renderer.render(model).array.clone() for _ in range(2)]
    torch.cuda.synchronize()
    assert counters["colors_gathered"] == before + 1
    assert torch.equal(images[0], images[1]) and images[0].any()
    filler.render_arrays(model.vertices_by_triangles,
                         model.normals_by_triangles,
                         model._colors[model._faces_vt.long()],
                         post="lambert_u8", light=shader.light_direction)
    assert torch.equal(filler.get_post_image(), images[0])


def randint_colors(renderer, model):
    """The fallback colours as ``torch.randint`` → ``.to()`` drew them:
    int64 on the host, a pageable copy, then the expand on the card."""
    t = model.n_triangles()
    per_tri = torch.randint(256, (t, 3), generator=renderer.generator)
    per_tri = per_tri.to(device=renderer.device, dtype=torch.float32)
    return per_tri[:, None, :].expand(t, 3, 3).contiguous()


def untextured_frame(cuda):
    """A lit 1024² renderer and the 16k-triangle sphere without colours."""
    model = chip_smoke.posed(Model(
        *chip_smoke.displaced_sphere(chip_smoke.TRI_SPHERE_SEGMENTS,
                                     chip_smoke.TRI_SPHERE_RINGS),
        device=cuda), True)
    assert not model.has_colors
    filler = pt.AdvancedPixelBufferFiller(1024, 1024, fov=chip_smoke.FOV,
                                          device=cuda)
    return pt.Renderer(filler, pt.GuroIllumination([0, 0, 1]),
                       pt.SimpleIterator, 1024, 1024), model


def test_untextured_frames_keep_the_randint_colours(cuda, monkeypatch):
    """Untextured frames at two seeds, the first queued behind a long
    kernel, equal the frames of the ``torch.randint`` → ``.to()`` colours.
    Three draws in a row, each queued behind a long kernel: the second and
    the third wait for the launch that read the pinned buffer before
    rewriting it, and each equals its ``randint`` colours."""
    renderer, model = untextured_frame(cuda)
    seeds = [3, 2 ** 62 + 7]
    torch.cuda._sleep(200_000_000)
    frames = []
    for seed in seeds:
        renderer.generator.manual_seed(seed)
        frames.append(renderer.render(model).array.clone())
    torch.cuda.synchronize()
    monkeypatch.setattr(renderer, "_fallback_colors",
                        lambda m, _random: randint_colors(renderer, m))
    for seed, frame in zip(seeds, frames):
        renderer.generator.manual_seed(seed)
        assert torch.equal(renderer.render(model).array, frame)
    monkeypatch.undo()
    torch.cuda.synchronize()
    event, waited = renderer._staging.event, []
    monkeypatch.setattr(event, "synchronize",
                        lambda wait=event.synchronize: (waited.append(1),
                                                        wait()))
    got = []
    for seed in [5, 6, 7]:
        torch.cuda._sleep(200_000_000)
        renderer.generator.manual_seed(seed)
        got.append(renderer._fallback_colors(model, True))
    assert len(waited) == 2
    for seed, colors in zip([5, 6, 7], got):
        renderer.generator.manual_seed(seed)
        assert torch.equal(colors, randint_colors(renderer, model))


def test_plain_backend_draws_the_same_colours_plainly(cuda):
    """A ``"torch"`` filler's renderer on the card: the same colours and
    frame as the kernel path's at one seed, with no ``csrc/colors.cu``
    launch and no pinned buffer."""
    renderer, model = untextured_frame(cuda)
    plain = pt.Renderer(pt.AdvancedPixelBufferFiller(
        1024, 1024, fov=chip_smoke.FOV, device=cuda, backend="torch"),
        pt.GuroIllumination([0, 0, 1]), pt.SimpleIterator, 1024, 1024)
    renderer.generator.manual_seed(9)
    plain.generator.manual_seed(9)
    want = renderer._fallback_colors(model, True)
    before = counters["launch.colors"]
    got = plain._fallback_colors(model, True)
    assert counters["launch.colors"] == before and plain._staging is None
    assert torch.equal(got, want)
    renderer.generator.manual_seed(9)
    plain.generator.manual_seed(9)
    assert torch.equal(plain.render(model).array,
                       renderer.render(model).array)


def test_fallback_colours_neither_sync_nor_copy(cuda):
    """Inside ``stage:crender.fallback_colors`` of a traced untextured
    frame the profiler sees one kernel launch (``csrc/colors.cu``, reading
    the pinned bytes) and no synchronisation and no copy."""
    from torch.profiler import ProfilerActivity, profile

    renderer, model = untextured_frame(cuda)
    renderer.render(model)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        renderer.render(model)
        torch.cuda.synchronize()
    host = [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if str(e.device_type).endswith("CPU")]
    spans = [(a, b) for n, a, b in host
             if n == "stage:crender.fallback_colors"]
    assert len(spans) == 1
    lo, hi = spans[0]
    inside = [n for n, a, _b in host if lo <= a <= hi]
    assert inside.count("cudaLaunchKernel") == 1
    for name in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                 "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpyAsync"):
        assert name not in inside
    assert any("vertex_colors_kernel" in e.name for e in prof.events())


@pytest.mark.parametrize("t", [0, 1, 255, 256, 257, 6016, 871_824])
def test_vertex_colors_kernel_matches_plain(cuda, t):
    """``csrc/colors.cu`` reads (T, 3) bytes from pinned memory and equals
    ``vertex_colors_plain`` bit for bit, one launch a call with triangles;
    bytes outside pinned memory are refused; without a stream it runs on
    the current one."""
    from cython3dmodelrenderer_tpu_torch.ops.colors import (
        vertex_colors, vertex_colors_plain)

    per_tri = torch.randint(256, (t, 3), generator=torch.Generator()
                            .manual_seed(t)).to(torch.uint8).pin_memory()
    stream = torch.cuda.current_stream(cuda)
    before = counters["launch.colors"]
    got = vertex_colors(per_tri, cuda, stream)
    torch.cuda.synchronize()
    assert got.device.type == "cuda" and got.is_contiguous()
    assert torch.equal(got.cpu(), vertex_colors_plain(per_tri))
    assert counters["launch.colors"] == before + (t > 0)
    if t:
        with pytest.raises(RuntimeError, match="vertex_colors"):
            vertex_colors(torch.from_numpy(per_tri.numpy().copy()), cuda,
                          stream)
        # the default stream is the device's current one
        assert torch.equal(vertex_colors(per_tri, cuda).cpu(), got.cpu())


# Last in the file: a profiler session before
# test_fallback_colours_neither_sync_nor_copy made that test's session miss
# vertex_colors_kernel's device event (torch 2.11 on an H100).
def test_the_frame_reads_its_total_after_the_raster(cuda):
    """In a profiled warm frame the device runs one copy to the host, the
    pair total's, and it starts after B1 (``raster_kernel``) ends: the host
    launched B4 and B1 before its read."""
    from torch.profiler import ProfilerActivity, profile

    tris, colors, normals = random_scene(2000, 5)
    tv, tn, tc = (torch.from_numpy(a).to(cuda) for a in (tris, normals, colors))
    config = RenderConfig(height=128, width=160, fov=60)

    def frame():
        return raster.render_frame(tv, tn, tc, config, post="lambert_u8",
                                   light=light_direction(), backend="cuda")

    frame()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        frame()
        torch.cuda.synchronize()
    device = [(e.name, e.time_range.start, e.time_range.end)
              for e in prof.events() if str(e.device_type).endswith("CUDA")]
    reads = [e for e in device if "DtoH" in e[0]]
    b1 = [e for e in device if "raster_kernel" in e[0]]
    assert len(reads) == 1 and len(b1) == 1, device
    assert reads[0][1] >= b1[0][2]
