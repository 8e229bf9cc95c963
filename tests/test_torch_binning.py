"""Port binning (pair expansion, B2's plain sort, per-tile bins) against JAX.

Integer work only, so every comparison is exact: the plain sort against
``sort_pallas.bitonic_sort_i32`` (interpret mode, as the JAX tests run
it), the pair expansion against ``binsort_pallas._expand_pairs``, and the
port's bins against a NumPy enumeration built from the JAX package's own
tile spans.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cython3dmodelrenderer_tpu.config import RenderConfig as JaxConfig
from cython3dmodelrenderer_tpu.ops import binning as jax_binning
from cython3dmodelrenderer_tpu.ops import binsort_pallas, sort_pallas
from cython3dmodelrenderer_tpu.ops.projection import (project_to_screen,
                                                      visibility_masks)

from cython3dmodelrenderer_tpu_torch.ops import binsort
from cython3dmodelrenderer_tpu_torch.ops.sort import sort_i32, sort_i32_plain
from test_torch_raster import random_scene


def unique_keys(n, seed):
    rng = np.random.RandomState(seed)
    # distinct keys spread over [0, 2^31): a permutation scaled up
    return (rng.permutation(n).astype(np.int64) * ((2 ** 31 - 1) // n)
            + rng.randint(0, (2 ** 31 - 1) // n)).astype(np.int32)


@pytest.mark.parametrize("n,seed", [(1, 0), (2, 1), (255, 2), (1000, 3),
                                    (4097, 4), (24576, 5), (40000, 6)])
def test_sort_matches_jax_bitonic(n, seed):
    keys = unique_keys(n, seed)
    want = np.asarray(sort_pallas.bitonic_sort_i32(jnp.asarray(keys),
                                                   interpret=True))
    np.testing.assert_array_equal(sort_i32_plain(torch.from_numpy(keys)).numpy(),
                                  want)


def test_sort_wrapper_runs_plain_on_cpu():
    keys = torch.from_numpy(unique_keys(777, 9))
    before = sort_i32.launches
    assert torch.equal(sort_i32(keys), sort_i32_plain(keys))
    assert sort_i32.launches == before
    with pytest.raises(ValueError):
        sort_i32(keys.to(torch.int64))


def jax_spans(t, seed, h, w):
    tris, colors, normals = random_scene(t, seed)
    tris[..., :2] *= 1.6                    # reach past the image edges
    config = JaxConfig(height=h, width=w, fov=60)
    tv, tn = jnp.asarray(tris), jnp.asarray(normals)
    deg, back = visibility_masks(tv, tn)
    ts = project_to_screen(tv, config)
    _rows, tx0, cx, ty0, cy, counts = jax_binning.plane_data(
        ts, ~deg & ~back, config, 16, 32)
    return [np.array(a) for a in (tx0, cx, ty0, cy, counts)]


SPANS = [(60, 0, 64, 64), (150, 1, 96, 128), (90, 2, 70, 100)]


@pytest.mark.parametrize("t,seed,h,w", SPANS)
def test_expand_pairs_matches_jax(t, seed, h, w):
    tx0, cx, ty0, cy, counts = jax_spans(t, seed, h, w)
    ntx = -(-w // 32)
    total = int(counts.sum())
    jtri, jtile, n_pairs, _ = binsort_pallas._expand_pairs(
        *map(jnp.asarray, (tx0, cx, ty0, cy)), ntx, total + 128)
    tri, tile = binsort.expand_pairs(*map(torch.from_numpy, (tx0, cx, ty0, cy)),
                                     ntx, total)
    assert int(n_pairs) == total > 0
    np.testing.assert_array_equal(tri.numpy(), np.asarray(jtri)[:total])
    np.testing.assert_array_equal(tile.numpy(), np.asarray(jtile)[:total])


@pytest.mark.parametrize("t,seed,h,w", SPANS)
def test_bins_match_numpy_enumeration(t, seed, h, w):
    tx0, cx, ty0, cy, counts = jax_spans(t, seed, h, w)
    ntx, nty = -(-w // 32), -(-h // 16)
    want = [[] for _ in range(ntx * nty)]
    for tri in range(t):                    # ascending triangle order
        for ty in range(ty0[tri], ty0[tri] + cy[tri]):
            for tx in range(tx0[tri], tx0[tri] + cx[tri]):
                want[ty * ntx + tx].append(tri)
    pair_tri, starts, tcounts = binsort.bin_pairs(
        *map(torch.from_numpy, (tx0, cx, ty0, cy)), ntx, nty,
        int(counts.sum()), sort=sort_i32_plain)
    pair_tri, starts, tcounts = (a.numpy() for a in (pair_tri, starts, tcounts))
    for tile in range(ntx * nty):
        got = pair_tri[starts[tile]:starts[tile] + tcounts[tile]].tolist()
        assert got == want[tile], f"tile {tile}"
    assert tcounts.sum() == counts.sum() == len(pair_tri)


def test_empty_bins_and_key_budget():
    zeros = torch.zeros(5, dtype=torch.int32)
    pair_tri, starts, counts = binsort.bin_pairs(zeros, zeros, zeros, zeros,
                                                 4, 3, 0)
    assert pair_tri.numel() == 0 and counts.sum() == 0 and len(starts) == 12
    assert binsort.key_bits(16128, 2048) == 14          # 14 + 11 bits
    assert binsort.key_bits(1, 1) == 1
    with pytest.raises(ValueError, match="31"):
        binsort.key_bits(1 << 21, 2048)
