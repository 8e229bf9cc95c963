"""Triangle → tile binning: pair expansion, key packing, sort, tile runs.

The part of ``cython3dmodelrenderer_tpu/ops/binsort_pallas.py::
bin_gather_grouped`` (``:437-624``) the port needs:

1. expand every active triangle into its (triangle, tile) pairs in
   triangle order, each triangle's tiles in row-major (dy, dx) order —
   exactly what ``_expand_pairs`` (``:182-242``) enumerates;
2. pack each pair as ``(tile << tri_bits) | tri`` and sort the keys with
   kernel B2 (``ops/sort.py``): pairs group by tile with ascending triangle
   order inside, the order the depth-tie rule needs;
3. cut the sorted keys into per-tile runs (``tile_starts``,
   ``tile_counts``) with a ``searchsorted`` over the tile boundaries.

The lane-class interleave, count-sorted group composition and capacity
clamping of the JAX binner are TPU layout work with no counterpart: the
raster kernel reads each tile's run directly. Sizes are exact: the caller
passes the frame's pair total (one host read per frame).
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from .sort import sort_i32


def key_bits(n_tris: int, n_tiles: int) -> int:
    """Bits of the triangle field in a pair key; raises past 31 bits."""
    tri_bits = max(1, (n_tris - 1).bit_length())
    tile_bits = max(1, (n_tiles - 1).bit_length())
    if tri_bits + tile_bits > 31:
        raise ValueError(
            f"{n_tris} triangles x {n_tiles} tiles need {tri_bits + tile_bits} "
            "key bits; the int32 pair key holds 31")
    return tri_bits


def expand_pairs(tx0: torch.Tensor, cx: torch.Tensor, ty0: torch.Tensor,
                 cy: torch.Tensor, ntx: int, total: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(triangle, tile) int32 ids of all ``total`` pairs, in triangle order
    and row-major (dy, dx) tile order within each triangle."""
    dev = tx0.device
    pc = (cx * cy).to(torch.int64)
    tri_ids = torch.arange(tx0.shape[0], device=dev)
    tri_p = torch.repeat_interleave(tri_ids, pc, output_size=total)
    off = torch.cumsum(pc, 0) - pc                 # run start per triangle
    k = torch.arange(total, device=dev) - off[tri_p]
    cx_p = cx[tri_p].to(torch.int64)
    dy = torch.div(k, cx_p, rounding_mode="floor")
    dx = k - dy * cx_p
    tile_p = (ty0[tri_p] + dy) * ntx + tx0[tri_p] + dx
    return tri_p.to(torch.int32), tile_p.to(torch.int32)


def bin_pairs(tx0: torch.Tensor, cx: torch.Tensor, ty0: torch.Tensor,
              cy: torch.Tensor, ntx: int, nty: int, total: int,
              sort: Callable[[torch.Tensor], torch.Tensor] = sort_i32
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-tile bins of the frame's pairs.

    Returns ``(pair_tri, tile_starts, tile_counts)``: ``pair_tri`` (total,)
    int32 holds the triangle ids of all pairs sorted by (tile, triangle);
    tile t's bin is ``pair_tri[tile_starts[t]:tile_starts[t] +
    tile_counts[t]]``. ``sort`` is B2's wrapper or its plain version.
    """
    n_tiles = ntx * nty
    tri_bits = key_bits(tx0.shape[0], n_tiles)
    dev = tx0.device
    if total == 0:
        zeros = torch.zeros(n_tiles, dtype=torch.int32, device=dev)
        return torch.zeros(0, dtype=torch.int32, device=dev), zeros, zeros
    tri_p, tile_p = expand_pairs(tx0, cx, ty0, cy, ntx, total)
    skeys = sort((tile_p << tri_bits) | tri_p)
    pair_tri = skeys & ((1 << tri_bits) - 1)
    # int64 boundaries: n_tiles << tri_bits may reach 2^31
    bounds = torch.searchsorted(
        skeys.to(torch.int64),
        torch.arange(n_tiles + 1, device=dev) << tri_bits).to(torch.int32)
    return pair_tri.contiguous(), bounds[:-1].contiguous(), \
        (bounds[1:] - bounds[:-1]).contiguous()
