"""B1's merge rule and bbox window, against NumPy walks of the old rule.

``raster_tiles_plain`` takes each pixel's winner as the minimum of the
kernel's (z bits, triangle) key; here it is held, bit for bit, to a NumPy
per-pixel strict-< walk of each tile's ascending bin (the rule of the
JAX kernels) on hand-made rows: z = -0.0 and +0.0 over the same pixels in
both orders, exact z ties, z exactly 0 and 1, NaN rows, empty bboxes and
bboxes past the frame, a partial edge tile (``chip_smoke.merge_case``),
and one tile of 1,000 candidates. ``bbox_window`` (the kernel's window)
is held to the per-pixel bbox compares. The kernel itself is held to the
plain version on the card (``test_torch_kernels_cuda.py``,
``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

import chip_smoke
from cython3dmodelrenderer_tpu_torch.ops import binning, binsort, raster


def walk_reference(kw):
    """(color, zbuf, normal) of a NumPy strict-< walk over each (view, tile)
    bin in ascending order, (V, H, W, C) float32, evaluated like the kernel:
    ``px*A + (py*B + C)`` in float32, the full per-pixel test."""
    rows = kw["rows"].numpy()
    pair_tri = kw["pair_tri"].numpy()
    starts, counts = kw["tile_starts"].numpy(), kw["tile_counts"].numpy()
    ntx, nty, h, w = kw["ntx"], kw["nty"], kw["height"], kw["width"]
    n_views = kw.get("n_views", 1)
    zbuf = np.full((n_views, h, w, 1), kw["z_init"], np.float32)
    color = np.zeros((n_views, h, w, 3), np.float32)
    normal = np.zeros((n_views, h, w, 3), np.float32)
    with np.errstate(all="ignore"):
        for tile in range(n_views * ntx * nty):
            view, local = divmod(tile, ntx * nty)
            xs = (local % ntx) * raster.TILE_W + np.arange(raster.TILE_W)
            ys = (local // ntx) * raster.TILE_H + np.arange(raster.TILE_H)
            px, py = (a.astype(np.float32) for a in np.meshgrid(xs, ys))
            best_z = np.full(px.shape, np.inf, np.float32)
            best = np.full(px.shape, -1)
            for tri in pair_tri[starts[tile]:starts[tile] + counts[tile]]:
                r = rows[tri]

                def plane(c, r=r):
                    return px * r[c] + (py * r[c + 1] + r[c + 2])

                z = plane(9)
                good = ((plane(0) >= 0) & (plane(3) >= 0) & (plane(6) >= 0)
                        & (px >= r[12]) & (px < r[13]) & (py >= r[14])
                        & (py < r[15]) & (z >= 0) & (z <= 1))
                win = good & (z < best_z)
                best_z[win], best[win] = z[win], tri
            for iy, y in enumerate(ys[ys < h]):
                for ix, x in enumerate(xs[xs < w]):
                    tri = best[iy, ix]
                    if tri < 0:
                        continue
                    zbuf[view, y, x, 0] = best_z[iy, ix]
                    r = rows[tri]
                    for ch in range(kw["n_attrs"]):
                        c = binning.IDX_ATTRS + 3 * ch
                        out = color if ch < 3 else normal
                        out[view, y, x, ch % 3] = (
                            px[iy, ix] * r[c] + (py[iy, ix] * r[c + 1]
                                                 + r[c + 2])) + np.float32(0.0)
    return color, zbuf, normal


def bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def assert_plain_matches_walk(kw):
    gbuf, _img = raster.raster_tiles_plain(**kw)
    n_views = kw.get("n_views", 1)
    for got, want in zip(gbuf, walk_reference(kw)):
        got = got.numpy().reshape(want.shape)
        np.testing.assert_array_equal(bits(got), bits(want))
    z = gbuf[1].numpy()
    return z.reshape((n_views,) + z.shape[-3:])


@pytest.mark.parametrize("n_views,seed", [(1, 0), (1, 1), (2, 2)])
def test_plain_merge_matches_the_walk(n_views, seed):
    z = assert_plain_matches_walk(chip_smoke.merge_case("cpu", n_views, seed))
    flat = z[..., 0]
    # the adversarial values reach the output
    assert ((flat == 0) & np.signbit(flat)).any()          # a -0.0 winner
    assert ((flat == 0) & ~np.signbit(flat)).any()         # a +0.0 winner
    assert (flat == 1).any() and ((flat > 0) & (flat < 1)).any()
    assert (flat == np.float32(1e6)).any()                 # uncovered pixels


def test_plain_merge_one_tile_matches_the_walk():
    """1,000 candidates in one tile (a quarter on 64 flat z levels: ties
    among many), binned by the counting sort's plain version."""
    n, ntx, nty = 1000, 32, 64
    bins = binsort.bin_sort_plain(*chip_smoke.one_tile_spans(n, ntx, nty,
                                                             "cpu"))
    kw = dict(rows=chip_smoke.one_tile_rows(n, ntx, nty, "cpu"),
              pair_tri=bins[0], tile_starts=bins[1], tile_counts=bins[2],
              ntx=ntx, nty=nty, height=nty * 16, width=ntx * 32, n_attrs=6,
              z_init=1e6)
    assert int(bins[2].max()) == n
    z = assert_plain_matches_walk(kw)
    assert (z < 1).sum() > 400


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bbox_window_matches_the_compares(seed):
    """``bbox_window`` holds exactly the integer positions of [t0, t1) that
    pass ``p >= lo`` and ``p < hi`` in float32, for NaN, ±inf, huge,
    integer and fractional bounds."""
    rng = np.random.default_rng(seed)
    special = np.float32([np.nan, np.inf, -np.inf, 1e30, -1e30, 0.0, -0.0,
                          31.5, 32.0, 47.25, 64.0, 63.999996, 100.0])
    n = 4000
    lo = rng.uniform(-20, 120, n).astype(np.float32)
    hi = (lo + rng.uniform(-10, 60, n)).astype(np.float32)
    pick = rng.random(n) < 0.3
    lo[pick] = np.round(lo[pick])
    pick = rng.random(n) < 0.2
    lo[pick] = rng.choice(special, int(pick.sum()))
    pick = rng.random(n) < 0.2
    hi[pick] = rng.choice(special, int(pick.sum()))
    t0 = rng.choice([0, 32, 64, 96], n)
    t1 = np.minimum(t0 + 32, rng.choice([80, 100, 128, 4096], n))
    first, count = raster.bbox_window(torch.from_numpy(lo),
                                      torch.from_numpy(hi),
                                      torch.from_numpy(t0),
                                      torch.from_numpy(t1))
    with np.errstate(invalid="ignore"):
        for i in range(n):
            p = np.arange(t0[i], max(t0[i], t1[i]))
            pf = p.astype(np.float32)
            passing = p[(pf >= lo[i]) & (pf < hi[i])]
            assert int(count[i]) == len(passing), (lo[i], hi[i], t0[i], t1[i])
            if len(passing):
                assert int(first[i]) == passing[0]
                assert passing[-1] - passing[0] + 1 == len(passing)
