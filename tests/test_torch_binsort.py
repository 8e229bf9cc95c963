"""Counting-sort binning (B4's plain version) against the JAX package.

``bin_sort_plain`` against ``binsort_pallas.bin_sort``, whose TPU kernel
runs on the CPU under ``force_tpu_interpret_mode`` — integer work, so the
comparison is exact: the placed ids ``order[:total]``, ``starts`` and
``counts`` (``p_cap >= total``, so JAX clamps nothing). Then the shape
the int32 pair key cannot hold, against a NumPy enumeration, and a frame
rendered through it.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from cython3dmodelrenderer_tpu.ops import binsort_pallas

from cython3dmodelrenderer_tpu_torch.config import RenderConfig
from cython3dmodelrenderer_tpu_torch.ops import binsort, binsort_grouped, raster
from cython3dmodelrenderer_tpu_torch.utils.timing import counters
from test_torch_raster import light_direction, random_scene


def random_spans(t, ntx, nty, max_span, seed, zero_frac=0.0):
    """(tx0, cx, ty0, cy) int32 spans inside the grid; ``zero_frac`` of the
    triangles get a culled (zero) span as ``plane_data`` writes it."""
    rng = np.random.RandomState(seed)
    tx0 = rng.randint(0, ntx, t)
    ty0 = rng.randint(0, nty, t)
    cx = np.minimum(rng.randint(1, max_span + 1, t), ntx - tx0)
    cy = np.minimum(rng.randint(1, max_span + 1, t), nty - ty0)
    culled = rng.rand(t) < zero_frac
    tx0[culled], ty0[culled], cx[culled], cy[culled] = 0, 0, 0, 0
    return [a.astype(np.int32) for a in (tx0, cx, ty0, cy)]


def covering_spans(ntx, nty, seed):
    """Nine single-tile triangles around one (id 4) that spans every tile."""
    tx0, cx, ty0, cy = random_spans(9, ntx, nty, 1, seed)
    ins = lambda a, v: np.insert(a, 4, v).astype(np.int32)  # noqa: E731
    return [ins(tx0, 0), ins(cx, ntx), ins(ty0, 0), ins(cy, nty)]


def enumerate_bins(spans, ntx, nty):
    """Each tile's triangle ids in ascending order, by walking the spans."""
    tx0, cx, ty0, cy = spans
    bins = [[] for _ in range(ntx * nty)]
    for tri in np.flatnonzero(cx * cy):
        for ty in range(ty0[tri], ty0[tri] + cy[tri]):
            for tx in range(tx0[tri], tx0[tri] + cx[tri]):
                bins[ty * ntx + tx].append(int(tri))
    return bins


# n_tiles and p_cap multiples of 128 (the TPU kernel's layout), <= 2k pairs
CASES = {
    "random": (random_spans(300, 16, 8, 4, 0), 16, 8),
    "single_tile": (random_spans(500, 32, 8, 1, 1), 32, 8),
    "culled": (random_spans(400, 16, 16, 3, 2, zero_frac=0.5), 16, 16),
    "covers_all": (covering_spans(16, 8, 3), 16, 8),
    "empty": (random_spans(64, 16, 8, 2, 4, zero_frac=1.0), 16, 8),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_bin_sort_plain_matches_jax_kernel(case):
    spans, ntx, nty = CASES[case]
    total = int((spans[1] * spans[3]).sum())
    p_cap = max(128, -(-total // 128) * 128)
    with pltpu.force_tpu_interpret_mode():
        order, starts, counts, jtotal, _n_active = binsort_pallas.bin_sort(
            *map(jnp.asarray, spans), ntx=ntx, nty=nty, p_cap=p_cap)
        order, starts, counts = (np.asarray(a) for a in (order, starts, counts))
    assert int(jtotal) == total <= 2048
    pair_tri, t_starts, t_counts = binsort.bin_sort_plain(
        *map(torch.from_numpy, spans), ntx, nty, total)
    np.testing.assert_array_equal(pair_tri.numpy(), order[:total])
    np.testing.assert_array_equal(t_starts.numpy(), starts)
    np.testing.assert_array_equal(t_counts.numpy(), counts)
    assert pair_tri.dtype == t_starts.dtype == t_counts.dtype == torch.int32


@pytest.mark.parametrize("case", ["random", "culled", "covers_all"])
def test_both_routes_give_the_same_bins(case):
    spans, ntx, nty = CASES[case]
    args = (*map(torch.from_numpy, spans), ntx, nty,
            int((spans[1] * spans[3]).sum()))
    for a, b in zip(binsort.bin_sort_plain(*args), binsort.bin_pairs(*args)):
        assert torch.equal(a, b)


def test_bin_sort_wrapper_runs_plain_on_cpu_and_raises_elsewhere():
    spans, ntx, nty = CASES["random"]
    args = (*map(torch.from_numpy, spans), ntx, nty,
            int((spans[1] * spans[3]).sum()))
    before = counters["launch.binsort"]
    for a, b in zip(binsort.bin_sort(*args), binsort.bin_sort_plain(*args)):
        assert torch.equal(a, b)
    assert counters["launch.binsort"] == before
    with pytest.raises(ValueError, match="unsupported device"):
        binsort.bin_sort(*(t.to("meta") for t in args[:4]), *args[4:])
    with pytest.raises(ValueError, match="int32"):
        binsort.bin_sort(args[0].to(torch.int64), *args[1:])


@pytest.mark.parametrize("case", ["random", "covers_all"])
def test_bin_slots_are_the_scalar_cursors(case):
    """B5 ranks each pair by its slot in B4's bins: bin slot j of tile t
    holds the pair whose cursor, in a scalar walk of the pairs in
    expansion order, read j - tile_starts[t]."""
    spans, ntx, nty = CASES[case]
    tx0, cx, ty0, cy = spans
    total = int((cx * cy).sum())
    pair_tri, starts, counts = binsort.bin_sort_plain(
        *map(torch.from_numpy, spans), ntx, nty, total)
    cursor = np.zeros(ntx * nty, np.int64)
    for tri in range(len(tx0)):
        for dy in range(cy[tri]):
            for dx in range(cx[tri]):
                tile = (ty0[tri] + dy) * ntx + tx0[tri] + dx
                assert 0 <= cursor[tile] < counts[tile]
                assert pair_tri[starts[tile] + cursor[tile]] == tri
                cursor[tile] += 1
    np.testing.assert_array_equal(cursor, counts.numpy())
    assert binsort_grouped.TILE_BITS + binsort_grouped.TRI_BITS == 31


def test_bins_past_the_int32_pair_key():
    """2^17 + 64 triangles over 32,768 tiles need 18 + 15 key bits: the
    sort route's key cannot hold them, the counting sort has no key."""
    t, ntx, nty = (1 << 17) + 64, 128, 256
    rng = np.random.RandomState(5)
    tx0, cx, ty0, cy = random_spans(t, ntx, nty, 3, 6, zero_frac=0.99)
    tx0[-1], cx[-1], ty0[-1], cy[-1] = 40, 64, 100, 64   # last id, 4096 tiles
    big = rng.randint(0, t - 1, 3)
    tx0[big], cx[big], ty0[big], cy[big] = 0, ntx, 0, 2  # two full rows
    spans = [tx0, cx, ty0, cy]
    total = int((cx * cy).sum())
    with pytest.raises(ValueError, match="31"):
        binsort.key_bits(t, ntx * nty)
    pair_tri, starts, counts = (a.numpy() for a in binsort.bin_sort_plain(
        *map(torch.from_numpy, spans), ntx, nty, total))
    want = enumerate_bins(spans, ntx, nty)
    np.testing.assert_array_equal(counts, [len(b) for b in want])
    np.testing.assert_array_equal(starts, np.cumsum(counts) - counts)
    np.testing.assert_array_equal(pair_tri, np.concatenate(
        [np.asarray(b, np.int64) for b in want]).astype(np.int32))
    assert total == len(pair_tri) > 4096


def test_frame_past_the_int32_pair_key_renders():
    """A frame the sort route could not bin (2^19 + 64 triangles at 2,080
    tiles: 20 + 12 key bits) renders through the counting sort, and equals
    the frame of its 24 live triangles alone (a sort-route frame)."""
    h, w = 1040, 1024
    live, colors, normals = random_scene(24, 11)
    pad = (1 << 19) + 64 - len(live)
    # zero-area triangles (culled), as tests/test_raster_pallas.py pads
    tris = np.concatenate([live, np.zeros((pad, 3, 3), np.float32) + [0, 0, 1]])
    colors_b = np.concatenate([colors, np.zeros((pad, 3, 3), np.float32)])
    normals_b = np.concatenate(
        [normals, np.tile(np.float32([0, 0, -1]), (pad, 3, 1))])
    config = RenderConfig(height=h, width=w, fov=60)
    with pytest.raises(ValueError, match="31"):
        binsort.key_bits(len(tris), -(-w // 32) * -(-h // 16))

    def frame(tv, tn, tc):
        return raster.render_frame(torch.from_numpy(tv), torch.from_numpy(tn),
                                   torch.from_numpy(tc), config,
                                   post="lambert_u8", light=light_direction(),
                                   gbuffer=True, group=16)

    (c_big, z_big, n_big), img_big, n_pairs = frame(tris, normals_b, colors_b)
    (c_ref, z_ref, n_ref), img_ref, ref_pairs = frame(live, normals, colors)
    assert n_pairs == ref_pairs > 0
    for a, b in ((c_big, c_ref), (z_big, z_ref), (n_big, n_ref),
                 (img_big, img_ref)):
        assert torch.equal(a, b)
    assert (z_big < 1.0).float().mean() > 0.05
