"""Group-interleaved binning (B5's plain versions) against the JAX package.

``bin_sort_grouped_plain`` (the whole wrapper's plain version) and
``place_from_bins_plain`` (the CUDA path's decomposition: ranks from
``bin_sort_plain``'s bins, the expansion's cut, the placement) against
``binsort_pallas.bin_sort_grouped``, whose TPU kernel runs on the CPU
under ``force_tpu_interpret_mode`` — integer work, so the comparison is
exact: every table (gstarts, gchunks, stids, sstripes, tile_counts,
total_slots, n_active) bit-equal, and ``order`` equal on the placed slots.
JAX leaves unplaced slots stale (clipped to [0, t]), the port fills them
with t; the placed slots come from a scalar walk of the pairs written here
in NumPy, the TPU kernel's cursor chain. Scenes:
``tests/test_raster_pallas.py:362-430`` (t=37, 4 x 8 tiles, group 4, sub
32, ample and 128 slots) and ``:605-645`` (t=300 at 128², group 8, sub
16), plus undersized capacities, the 1024² frame's group=16/sub=8, scenes
with culled or no pairs, and slot caps that cut the expansion inside a
triangle's span, at a triangle's first pair and at exactly its end.
"""
import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from cython3dmodelrenderer_tpu.ops import binning as jax_binning
from cython3dmodelrenderer_tpu.ops import binsort_pallas
from cython3dmodelrenderer_tpu.config import RenderConfig as JConfig

from cython3dmodelrenderer_tpu_torch.ops import binsort, binsort_grouped
from cython3dmodelrenderer_tpu_torch.utils.timing import counters
from test_torch_binsort import random_spans


def oracle_spans(seed=3, t=37, ntx=4, nty=8):
    """``test_binsort_grouped_overflow_clamps_and_unroll_tail``'s spans."""
    rng = np.random.RandomState(seed)
    tx0 = rng.randint(0, ntx, t)
    ty0 = rng.randint(0, nty, t)
    cx = np.minimum(rng.randint(1, 4, t), ntx - tx0)
    cy = np.minimum(rng.randint(1, 4, t), nty - ty0)
    return [a.astype(np.int32) for a in (tx0, cx, ty0, cy)]


def frame_spans():
    """``test_sorted_gather_binning_matches_scalar_placement``'s frame:
    300 random triangles at 128² (4 x 8 tiles), 10% culled."""
    rng = np.random.RandomState(7)
    t = 300
    config = JConfig(height=128, width=128, fov=60)
    pts = rng.rand(t, 3, 2) * 140 - 6
    z = rng.rand(t, 3, 1) * 0.9 + 0.05
    ts = jnp.asarray(np.concatenate([pts, z], -1).astype(np.float32))
    act = jnp.asarray(rng.rand(t) > 0.1)
    _rows, tx0, cx, ty0, cy, counts = jax_binning.plane_data(ts, act, config,
                                                             16, 32)
    p_cap = jax_binning.capacity_bucket(int(jnp.sum(counts)), 128)
    return [np.array(a, np.int32) for a in (tx0, cx, ty0, cy)], p_cap


def cut_spans(cap, offset, tail=True, seed=11, ntx=16, nty=16):
    """Spans whose expansion reaches ``cap`` pairs ``offset`` pairs into
    the 4 x 3 span of one triangle (``offset`` 0: at its first pair, right
    after two culled triangles), followed by random triangles; ``tail``
    False: no such triangle and nothing after, so the expansion ends at
    ``cap`` exactly."""
    tx0, cx, ty0, cy = random_spans(4 * cap, ntx, nty, 4, seed, zero_frac=0.1)
    pc = cx * cy
    head = int(np.searchsorted(np.cumsum(pc), cap - offset - ntx, "right"))
    room = cap - offset - int(pc[:head].sum())        # ntx < room < 2 ntx
    rows = [(0, min(room, ntx), 0, 1), (0, room - min(room, ntx), 1, 1)]
    if tail:
        rows += [(0, 0, 0, 0), (0, 0, 0, 0), (5, 4, 6, 3)]
    extra = np.asarray(rows, np.int32).T
    out = [np.concatenate([a[:head], e, a[head:head + 40] if tail else []])
           for a, e in zip((tx0, cx, ty0, cy), extra)]
    return [a.astype(np.int32) for a in out]


def ample_cap(spans, ntx, nty, group, sub):
    return 128 * int(jnp.sum(binsort_pallas.group_histogram(
        *map(jnp.asarray, spans), ntx, nty, group, sub)[3]))


def cases():
    small = oracle_spans()
    frame, frame_cap = frame_spans()
    wide = random_spans(500, 32, 16, 3, 8, zero_frac=0.3)   # 512 tiles
    out = {}
    for tag, cap in (("ample", ample_cap(small, 4, 8, 4, 32)), ("128", 128)):
        out[f"t37_{tag}"] = (small, 4, 8, cap, 4, 32)
    out["t300_bucket"] = (frame, 4, 8, frame_cap, 8, 16)
    out["t300_ample"] = (frame, 4, 8, ample_cap(frame, 4, 8, 8, 16), 8, 16)
    out["t300_640"] = (frame, 4, 8, 640, 8, 16)               # undersized
    out["wide_g16_ample"] = (wide, 32, 16, ample_cap(wide, 32, 16, 16, 8),
                             16, 8)
    out["wide_g16_1024"] = (wide, 32, 16, 1024, 16, 8)         # undersized
    out["no_pairs"] = (random_spans(64, 4, 8, 2, 4, zero_frac=1.0), 4, 8,
                       128, 8, 16)
    out["cut_mid_span"] = (cut_spans(256, 7), 16, 16, 256, 8, 16)
    out["cut_first_pair"] = (cut_spans(256, 0), 16, 16, 256, 8, 16)
    out["cut_at_total"] = (cut_spans(384, 0, tail=False), 16, 16, 384, 16, 8)
    return out


CASES = cases()


@functools.lru_cache(maxsize=None)
def jax_grouped(case):
    """``binsort_pallas.bin_sort_grouped`` on ``CASES[case]``, in interpret
    mode, as NumPy arrays."""
    spans, ntx, nty, slot_cap, group, sub = CASES[case]
    with pltpu.force_tpu_interpret_mode():
        want = binsort_pallas.bin_sort_grouped(
            *map(jnp.asarray, spans), ntx=ntx, nty=nty, slot_cap=slot_cap,
            group=group, sub=sub)
        return [np.asarray(a) for a in want]


def expansion(spans):
    """Every (triangle, tile-in-span index) pair in expansion order."""
    tx0, cx, ty0, cy = spans
    return [(tri, i) for tri in range(len(tx0)) for i in range(cx[tri] * cy[tri])]


def scalar_walk(spans, ntx, nty, slot_cap, group, sub, gstarts, stids):
    """The TPU kernel's placement as a scalar loop: {slot: triangle}."""
    tx0, cx, ty0, cy = spans
    n_tiles = ntx * nty
    pairs = [(tri, (ty0[tri] + dy) * ntx + tx0[tri] + dx)
             for tri in range(len(tx0)) for dy in range(cy[tri])
             for dx in range(cx[tri])][:slot_cap]
    k_of = {int(tile): k for k, tile in enumerate(stids[:n_tiles])}
    cursor = np.zeros(n_tiles, np.int64)
    placed = {}
    for tri, tile in pairs:
        k = k_of[tile]
        g = k // group
        base = gstarts[g] + k % group
        b = max(int(gstarts[g + 1] - gstarts[g]) // (group * sub), 1)
        r = cursor[tile]
        pos = base + (r % b) * group * sub + (r // b) * group
        if pos < gstarts[g + 1] and r < b * sub:
            placed[int(pos)] = tri
        cursor[tile] += 1
    return placed


def assert_matches_jax(case, got):
    """``got`` (B5's 8 outputs) against the JAX kernel's tables and the
    scalar walk's placed slots; returns the number placed."""
    spans, ntx, nty, slot_cap, group, sub = CASES[case]
    want = jax_grouped(case)
    assert len(got) == len(want) == 8
    for name, a, b in zip(("gstarts", "gchunks", "stids", "sstripes",
                           "tile_counts", "total_slots", "n_active"),
                          got[1:], want[1:]):
        assert a.dtype == torch.int32, name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    t = len(spans[0])
    placed = scalar_walk(spans, ntx, nty, slot_cap, group, sub, want[1],
                         want[3])
    order, jorder = got[0].numpy(), want[0]
    assert order.shape == jorder.shape == (slot_cap,)
    slots = np.fromiter(placed, np.int64, len(placed))
    tris = np.fromiter(placed.values(), np.int64, len(placed))
    np.testing.assert_array_equal(order[slots], tris)
    np.testing.assert_array_equal(jorder[slots], tris)
    unplaced = np.ones(slot_cap, bool)
    unplaced[slots] = False
    assert np.all(order[unplaced] == t)
    return len(placed)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bin_sort_grouped_plain_matches_jax_kernel(case):
    spans, ntx, nty, slot_cap, group, sub = CASES[case]
    got = binsort_grouped.bin_sort_grouped_plain(
        *map(torch.from_numpy, spans), ntx, nty, slot_cap, group, sub)
    placed = assert_matches_jax(case, got)
    total = int((spans[1] * spans[3]).sum())
    if case == "no_pairs":
        assert total == 0 and not placed
    elif slot_cap >= int(jax_grouped(case)[6]):  # ample: every pair placed
        assert placed == total > 0
    else:                                   # undersized: some pairs dropped
        assert 0 < placed < total


@pytest.mark.parametrize("case", sorted(CASES))
def test_place_from_bins_plain_matches_jax_kernel(case):
    """The CUDA path's decomposition on B4's plain bins: bit-equal to the
    whole wrapper's plain version in all 8 outputs, and to JAX."""
    spans, ntx, nty, slot_cap, group, sub = CASES[case]
    tspans = list(map(torch.from_numpy, spans))
    total = int((spans[1] * spans[3]).sum())
    bins = binsort.bin_sort_plain(*tspans, ntx, nty, total)
    got = binsort_grouped.place_from_bins_plain(bins, *tspans, ntx, nty,
                                                slot_cap, group, sub)
    want = binsort_grouped.bin_sort_grouped_plain(*tspans, ntx, nty,
                                                  slot_cap, group, sub)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert_matches_jax(case, got)


def test_cut_cases_cut_where_they_say():
    """The cut cases' spans: slot_cap falls 7 pairs into a span, at a
    triangle's first pair after two culled ones, and at the end."""
    for case, (cut_at, cap) in {"cut_mid_span": (7, 256),
                                "cut_first_pair": (0, 256),
                                "cut_at_total": (None, 384)}.items():
        spans = CASES[case][0]
        pairs = expansion(spans)
        assert CASES[case][3] == cap
        if cut_at is None:
            assert len(pairs) == cap
            continue
        tri, index = pairs[cap]
        assert index == cut_at and spans[1][tri] * spans[3][tri] == 12
        if cut_at == 0:
            assert spans[1][tri - 1] == spans[1][tri - 2] == 0


CUT_SPANS = cut_spans(256, 7)
CUT_TOTAL = int((CUT_SPANS[1] * CUT_SPANS[3]).sum())


@pytest.mark.parametrize("n_pairs", [0, 1, 15, 249, 256, 257, CUT_TOTAL - 1,
                                     CUT_TOTAL, CUT_TOTAL + 5])
def test_clamp_cut_matches_the_expansion(n_pairs):
    """``clamp_cut``: the triangle holding expansion pair ``n_pairs`` and
    how many of its pairs come before it (``(t, 0)`` past the end)."""
    pairs = expansion(CUT_SPANS)
    tc, keep = binsort_grouped.clamp_cut(
        torch.from_numpy(CUT_SPANS[1]), torch.from_numpy(CUT_SPANS[3]), n_pairs)
    if n_pairs >= len(pairs):
        assert (tc, keep) == (len(CUT_SPANS[0]), 0)
    else:
        assert (tc, keep) == pairs[n_pairs]
        assert sum(1 for tri, _i in pairs[:n_pairs] if tri == tc) == keep


def test_wrapper_runs_plain_on_cpu_and_checks_its_limits():
    spans, ntx, nty, slot_cap, group, sub = CASES["t300_bucket"]
    args = (*map(torch.from_numpy, spans), ntx, nty, slot_cap, group, sub)
    before = counters["launch.binsort_grouped"]
    for a, b in zip(binsort_grouped.bin_sort_grouped(*args),
                    binsort_grouped.bin_sort_grouped_plain(*args)):
        assert torch.equal(a, b)
    assert counters["launch.binsort_grouped"] == before
    with pytest.raises(ValueError, match="unsupported device"):
        binsort_grouped.bin_sort_grouped(*(t.to("meta") for t in args[:4]),
                                         *args[4:])
    t4 = [torch.zeros(4, dtype=torch.int32)] * 4
    with pytest.raises(ValueError, match="128"):
        binsort_grouped.bin_sort_grouped(*t4, 4, 8, 128, 8, 8)
    with pytest.raises(ValueError, match="multiple of 128"):
        binsort_grouped.bin_sort_grouped(*t4, 4, 8, 100, 8, 16)
    with pytest.raises(ValueError, match="63 tiles"):
        binsort_grouped.bin_sort_grouped(*t4, 64, 8, 128, 8, 16)
    with pytest.raises(ValueError, match="2\\^14"):
        binsort_grouped.bin_sort_grouped(*t4, 32, 512, 128, 8, 16)
    big = [torch.zeros(1 << 17, dtype=torch.int32)] * 4
    with pytest.raises(ValueError, match="2\\^17"):
        binsort_grouped.bin_sort_grouped(*big, 4, 8, 128, 8, 16)


def test_compose_groups_sorts_with_b2_or_torch_sort():
    """The tile-key caller of B2: the packed keys are unique, so any sort of
    them (B2 on the card, ``torch.sort`` here) gives the composition a
    lexicographic sort by (descending stripes, tile) gives."""
    rng = np.random.RandomState(1)
    counts = rng.randint(0, 40, 90).astype(np.int32)
    counts[rng.rand(90) < 0.2] = 0
    stids, sstripes, gchunks = binsort_grouped.compose_groups(
        torch.from_numpy(counts), 16, 8)
    stripes = -(-counts // 8)
    want = np.lexsort((np.arange(90), -stripes))
    assert stids.shape == (96,) and gchunks.shape == (6,)
    np.testing.assert_array_equal(stids[:90].numpy(), want)
    np.testing.assert_array_equal(sstripes[:90].numpy(), stripes[want])
    assert stids[90:].tolist() == [90] * 6
    assert sstripes[90:].tolist() == [0] * 6
    np.testing.assert_array_equal(gchunks.numpy(), sstripes[::16].numpy())
