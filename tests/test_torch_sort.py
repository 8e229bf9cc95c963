"""The radix-sort core's pass planner and B2's wrapper on the CPU.

``ops/sort.py::plan`` and ``ops/binsort.py::bin_sort_plan`` size every
launch of ``csrc/radix_sort.cu`` (digit width, passes, the one-launch or
onesweep path, scratch words, device operations); they are checked here at
the shapes ``chip_smoke.py`` drives. On a CPU tensor ``sort_i32(keys,
bits)`` runs its plain version, held against the JAX package's
``bitonic_sort_i32`` (interpret mode) for keys of the given width; the
callers pass the width of their keys; other devices raise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cython3dmodelrenderer_tpu.ops import sort_pallas

from cython3dmodelrenderer_tpu_torch.ops import binsort, binsort_grouped, sort
from cython3dmodelrenderer_tpu_torch.ops.sort import sort_i32, sort_i32_plain
from cython3dmodelrenderer_tpu_torch.utils.timing import counters


def test_digit_width_and_passes():
    assert sort.RADIX_BITS == 8 and sort.RADIX == 256
    for bits, passes in [(1, 1), (8, 1), (9, 2), (11, 2), (16, 2), (17, 3),
                         (25, 4), (29, 4), (31, 4)]:
        assert sort.plan(1000, bits).passes == passes


@pytest.mark.parametrize("bits", [0, 32, -1])
def test_plan_refuses_widths_outside_1_to_31(bits):
    with pytest.raises(ValueError, match="bits"):
        sort.plan(10, bits)


# (n, bits) at the smoke's shapes: igor_sphere@1024's and sphere16k@1024's
# pair keys, the sweep's view_batch 2 and 4 batches, both sides of the
# one-launch limit, 2^18 + 17 keys; (one launch, tiles, scratch words,
# device operations)
PLANS = {
    (11979, 24): (True, 6, 6 * 256, 1),
    (17473, 25): (True, 9, 9 * 256, 1),
    (39180, 27): (True, 20, 20 * 256, 1),
    (82483, 29): (True, 41, 41 * 256, 1),
    (131072, 29): (True, 64, 64 * 256, 1),
    (131073, 29): (False, 65, 4 * 257 + 4 * 65 * 256, 6),
    ((1 << 18) + 17, 31): (False, 129, 4 * 257 + 4 * 129 * 256, 6),
    ((1 << 18) + 17, 8): (False, 129, 257 + 129 * 256, 3),
}


@pytest.mark.parametrize("n,bits", sorted(PLANS))
def test_plan_at_the_smoke_shapes(n, bits):
    one_launch, tiles, words, launches = PLANS[(n, bits)]
    p = sort.plan(n, bits)
    assert (p.one_launch, p.tiles, p.scratch_words, p.launches) == \
        (one_launch, tiles, words, launches)
    assert p.one_launch == (n <= sort.ONE_LAUNCH_MAX_KEYS)
    assert p.tiles * sort.TILE_KEYS >= n > (p.tiles - 1) * sort.TILE_KEYS


def test_plan_of_no_keys_launches_nothing():
    p = sort.plan(0, 25)
    assert (p.one_launch, p.tiles, p.scratch_words, p.launches) == (True, 0, 0, 0)


# bin_sort at the smoke's frames: (triangles, tiles, pairs) -> (tile bits,
# one-launch sort, sort passes, device operations)
BIN_PLANS = {
    "sphere16k@1024": ((16128, 2048, 17473), (11, True, 2, 4)),
    "sphere16k@2048": ((16128, 8192, 44409), (13, True, 2, 4)),
    "torus262k@1024": ((262144, 2048, 161209), (11, False, 2, 5)),
    "torus262k@4096": ((262144, 32768, 361162), (15, False, 2, 5)),
    "8192^2": ((1 << 18, 131072, 400000), (17, False, 3, 6)),
    "one tile": ((200000, 2048, 200000), (11, False, 2, 5)),
    "no pairs": ((4096, 2048, 0), (11, True, 2, 1)),
}


@pytest.mark.parametrize("case", sorted(BIN_PLANS))
def test_bin_sort_plan_at_the_smoke_shapes(case):
    (n_tris, n_tiles, total), (bits, one_launch, passes, launches) = \
        BIN_PLANS[case]
    p = binsort.bin_sort_plan(n_tris, n_tiles, total)
    assert binsort.tile_bits(n_tiles) == bits
    assert p.sort == sort.plan(total, bits)
    assert (p.sort.one_launch, p.sort.passes, p.launches) == \
        (one_launch, passes, launches)
    assert p.scratch_words == (2 * n_tiles + 2 + -(-n_tris // 1024)
                               + -(-n_tiles // 1024) + p.sort.scratch_words)


def keys_of_width(n, bits, seed):
    """``n`` keys in [0, 2^bits) with duplicates, holding 2^bits - 1 and 0."""
    rng = np.random.RandomState(seed)
    keys = rng.randint(0, 1 << bits, n, dtype=np.int64)
    keys[::5] = keys[0]
    keys[1::9] = (1 << bits) - 1
    keys[2::17] = 0
    return keys.astype(np.int32)


@pytest.mark.parametrize("bits", [11, 25, 31])
@pytest.mark.parametrize("n", [1, 1000, 17473])
def test_sort_matches_jax_bitonic_at_a_width(bits, n):
    keys = keys_of_width(n, bits, n + bits)
    want = np.asarray(sort_pallas.bitonic_sort_i32(jnp.asarray(keys),
                                                   interpret=True))
    before = counters["launch.sort"]
    got = sort_i32(torch.from_numpy(keys), bits)
    assert counters["launch.sort"] == before
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        sort_i32_plain(torch.from_numpy(keys), bits).numpy(), want)


def test_sort_refuses_widths_and_other_devices():
    keys = torch.from_numpy(keys_of_width(100, 11, 0))
    for bits in (0, 32):
        with pytest.raises(ValueError, match="bits"):
            sort_i32(keys, bits)
    with pytest.raises(ValueError, match="unsupported device"):
        sort_i32(keys.to("meta"), 11)
    with pytest.raises(ValueError, match="int32"):
        sort_i32(keys.to(torch.int64), 11)


def test_bin_sort_refuses_other_devices():
    ones = torch.ones(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        binsort.bin_sort(ones, ones, ones, ones, 4, 4, 8)


@pytest.mark.parametrize("n_tris,ntx,nty", [(1000, 32, 64), (16128, 32, 64),
                                            (5, 3, 1), (1, 1, 1)])
def test_bin_pairs_sorts_on_the_key_width(n_tris, ntx, nty):
    """bin_pairs hands its sort ``tri_bits + tile_bits``, and the keys fit."""
    rng = np.random.RandomState(n_tris)
    tx0 = rng.randint(0, ntx, n_tris).astype(np.int32)
    ty0 = rng.randint(0, nty, n_tris).astype(np.int32)
    cx = np.minimum(2, ntx - tx0).astype(np.int32)
    cy = np.ones(n_tris, np.int32)
    seen = []

    def recording_sort(keys, bits):
        seen.append((bits, int(keys.max())))
        return sort_i32_plain(keys, bits)

    spans = (*map(torch.from_numpy, (tx0, cx, ty0, cy)), ntx, nty,
             int((cx * cy).sum()))
    got = binsort.bin_pairs(*spans, sort=recording_sort)
    tri_bits = binsort.key_bits(n_tris, ntx * nty)
    [(bits, top)] = seen
    assert bits == tri_bits + binsort.tile_bits(ntx * nty)
    assert top < 1 << bits
    for a, b in zip(got, binsort.bin_sort_plain(*spans)):
        assert torch.equal(a, b)


def test_compose_groups_sorts_on_the_packed_key_width(monkeypatch):
    """The plain composition sorts the 31-bit packed tile keys, the width
    the CUDA path hands B2 (the card test records that call)."""
    seen = []

    def recording_sort(keys, bits):
        seen.append((bits, int(keys.max())))
        return sort_i32_plain(keys, bits)

    monkeypatch.setattr(binsort_grouped, "sort_i32_plain", recording_sort)
    counts = torch.from_numpy(np.random.RandomState(0).randint(
        0, 40, 64).astype(np.int32))
    binsort_grouped.compose_groups(counts, 16, 8)
    [(bits, top)] = seen
    assert bits == binsort_grouped.TRI_BITS + binsort_grouped.TILE_BITS == 31
    assert top < 1 << bits
