"""Triangle → tile binning: the two routes that build each tile's bin.

Both routes return ``(pair_tri, tile_starts, tile_counts)``: ``pair_tri``
(total,) int32 holds the triangle ids of all (triangle, tile) pairs grouped
by tile, each tile's run in ascending triangle order (the order the
depth-tie rule needs); tile t's bin is ``pair_tri[tile_starts[t]:]
[:tile_counts[t]]``. Sizes are exact: the caller passes the frame's pair
total (one host read per frame).

**Sort route** (``bin_pairs``), the part of ``cython3dmodelrenderer_tpu/
ops/binsort_pallas.py::bin_gather_grouped`` (``:437-624``) the port needs:

1. expand every active triangle into its (triangle, tile) pairs in
   triangle order, each triangle's tiles in row-major (dy, dx) order —
   exactly what ``_expand_pairs`` (``:182-242``) enumerates;
2. pack each pair as ``(tile << tri_bits) | tri`` and sort the keys with
   kernel B2 (``ops/sort.py``) on their ``tri_bits + tile_bits`` bits;
3. cut the sorted keys into per-tile runs with a ``searchsorted``.

The int32 key bounds this route (``key_bits``); ``render_frame`` takes it
only inside ``grouped_limits_ok``, which implies the bound.

**Counting-sort route** (``bin_sort``), the counterpart of
``binsort_pallas.bin_sort`` (TPU kernel ``_make_kernel``, ``:42``) as
``binning.bin_pairs_fast`` calls it: no pair key, so no bit limit. On a
CUDA tensor it runs B4 on the radix-sort core of ``csrc/radix_sort.cu``
(expansion, a stable sort of the tile ids carrying the triangle ids, the
bin starts); on a CPU tensor it runs ``bin_sort_plain``.

The lane-class interleave, count-sorted group composition and capacity
clamping of the JAX binners are TPU layout work with no counterpart: the
raster kernel reads each tile's run directly.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from .. import cuda_build
from ..utils import timing
from . import sort as radix
from .sort import sort_i32

Bins = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

#: triangles one B4 expansion CTA takes, tile counts one scan CTA takes
#: (``csrc/radix_sort.cu``)
EXPAND_TRIS = 1024
SCAN_TILES = 1024


def key_bits(n_tris: int, n_tiles: int) -> int:
    """Bits of the triangle field in a pair key; raises past 31 bits."""
    tri_bits = max(1, (n_tris - 1).bit_length())
    if tri_bits + tile_bits(n_tiles) > 31:
        raise ValueError(
            f"{n_tris} triangles x {n_tiles} tiles need "
            f"{tri_bits + tile_bits(n_tiles)} key bits; the int32 pair key "
            "holds 31")
    return tri_bits


def tile_bits(n_tiles: int) -> int:
    """Bits of a tile id: ``ceil(log2 n_tiles)``, at least 1."""
    return max(1, (n_tiles - 1).bit_length())


def grouped_limits_ok(n_tris: int, slot_cap: int, ntx: int, nty: int) -> bool:
    """``binsort_pallas.grouped_limits_ok`` (``:346``): the budget inside
    which the JAX package renders a ``group > 1`` frame grouped. The port
    takes its sort route exactly there (``slot_cap`` = the frame's pair
    total); 17 triangle bits + 14 tile bits keep the pair key in 31."""
    return (n_tris < (1 << 17) and slot_cap < (1 << 17) and ntx <= 63
            and ntx * nty < (1 << 14))


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
              sort: Callable[[torch.Tensor, int], torch.Tensor] = sort_i32
              ) -> Bins:
    """Per-tile bins by sorting packed pair keys (the sort route).

    ``sort(keys, bits)`` is B2's wrapper or its plain version; it gets the
    keys' width, ``tri_bits + tile_bits``. Raises (``key_bits``) when a
    pair key would not fit in int32.
    """
    n_tiles = ntx * nty
    tri_bits = key_bits(tx0.shape[0], n_tiles)
    dev = tx0.device
    if total == 0:
        zeros = torch.zeros(n_tiles, dtype=torch.int32, device=dev)
        return torch.zeros(0, dtype=torch.int32, device=dev), zeros, zeros
    tri_p, tile_p = expand_pairs(tx0, cx, ty0, cy, ntx, total)
    skeys = sort((tile_p << tri_bits) | tri_p, tri_bits + tile_bits(n_tiles))
    pair_tri = skeys & ((1 << tri_bits) - 1)
    # int64 boundaries: n_tiles << tri_bits may reach 2^31
    bounds = torch.searchsorted(
        skeys.to(torch.int64),
        torch.arange(n_tiles + 1, device=dev) << tri_bits).to(torch.int32)
    return pair_tri.contiguous(), bounds[:-1].contiguous(), \
        (bounds[1:] - bounds[:-1]).contiguous()


def _check_spans(tx0, cx, ty0, cy) -> None:
    for name, t in (("tx0", tx0), ("cx", cx), ("ty0", ty0), ("cy", cy)):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int32 tensor")
        if t.shape != tx0.shape or t.device != tx0.device:
            raise ValueError(f"{name} must match tx0's shape and device")


def bin_sort_plain(tx0: torch.Tensor, cx: torch.Tensor, ty0: torch.Tensor,
                   cy: torch.Tensor, ntx: int, nty: int, total: int) -> Bins:
    """The plain version of ``bin_sort``: ``expand_pairs``, a stable sort
    of the pairs' tile ids, ``bincount`` and an exclusive ``cumsum``."""
    _check_spans(tx0, cx, ty0, cy)
    tri_p, tile_p = expand_pairs(tx0, cx, ty0, cy, ntx, total)
    order = torch.sort(tile_p, stable=True).indices
    counts = torch.bincount(tile_p.to(torch.int64), minlength=ntx * nty)
    starts = torch.cumsum(counts, 0) - counts
    return (tri_p[order].contiguous(), starts.to(torch.int32),
            counts.to(torch.int32))


class BinSortPlan(NamedTuple):
    sort: radix.SortPlan   # the core's sort of the tile ids
    scratch_words: int     # starts, counts, expansion and sort scratch
    launches: int          # device operations of one call


def bin_sort_plan(n_tris: int, n_tiles: int, total: int) -> BinSortPlan:
    """How ``bin_sort`` sizes a call (``csrc/radix_sort.cu::
    binsort_launch``): one scratch of tile_starts, tile_counts, the
    expansion's ticket and look-back words (one a ``EXPAND_TRIS``
    triangles), the starts scan's (one a ``SCAN_TILES`` tiles) and the
    sort's scratch. Launches: the memset, then with pairs the expansion,
    the starts scan and the sort (one launch up to
    ``sort.ONE_LAUNCH_MAX_KEYS`` pairs, one a pass past it)."""
    sort_plan = radix.plan(total, tile_bits(n_tiles))
    words = (2 * n_tiles + 2 + -(-n_tris // EXPAND_TRIS)
             + -(-n_tiles // SCAN_TILES) + sort_plan.scratch_words)
    if total == 0 or n_tris == 0:
        return BinSortPlan(sort_plan, words, 1)
    sort_launches = 1 if sort_plan.one_launch else sort_plan.passes
    return BinSortPlan(sort_plan, words, 3 + sort_launches)


def bin_sort(tx0: torch.Tensor, cx: torch.Tensor, ty0: torch.Tensor,
             cy: torch.Tensor, ntx: int, nty: int, total: int) -> Bins:
    """Counting-sort every triangle into the bins of the tiles it spans.

    ``tx0, cx, ty0, cy`` (T,) int32 tile spans inside the ``ntx x nty``
    grid (a culled triangle has a zero span); ``total`` = Σ cx·cy. Returns
    the bins (module docstring), bit-equal to ``bin_sort_plain``. CUDA
    tensors run kernel B4 in one C call (``bin_sort_plan``): the expansion
    writes the pairs and counts them per tile, the radix-sort core sorts
    their tile ids stably carrying the triangle ids, a scan gives the bin
    starts; ``tile_starts`` and ``tile_counts`` are views of one buffer.
    CPU tensors run ``bin_sort_plain``; any other device raises.
    """
    _check_spans(tx0, cx, ty0, cy)
    if tx0.device.type == "cpu":
        return bin_sort_plain(tx0, cx, ty0, cy, ntx, nty, total)
    if tx0.device.type != "cuda":
        raise ValueError(f"bin_sort: unsupported device {tx0.device}")
    dev = tx0.device
    n_tris, n_tiles = tx0.shape[0], ntx * nty
    sort_plan = bin_sort_plan(n_tris, n_tiles, total)
    scratch = torch.empty(sort_plan.scratch_words, dtype=torch.int32, device=dev)
    pair_tri = torch.empty(total, dtype=torch.int32, device=dev)
    # the sorted keys, the ping-pong keys and values
    work = torch.empty(3 * total, dtype=torch.int32, device=dev)
    lib = radix._lib()
    err = lib.binsort_launch(
        *(t.data_ptr() for t in (tx0, cx, ty0, cy)), n_tris, ntx, n_tiles,
        total, tile_bits(n_tiles), scratch.data_ptr(), work.data_ptr(),
        pair_tri.data_ptr(), dev.index, cuda_build.stream_handle(dev))
    cuda_build.check(lib, err, "bin_sort (csrc/radix_sort.cu)")
    if total > 0 and n_tris > 0:
        timing.counters["launch.binsort"] += 1
    return pair_tri, scratch[:n_tiles], scratch[n_tiles:2 * n_tiles]
