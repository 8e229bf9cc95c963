"""Group-interleaved, count-sorted tile bins — kernel B5 and its plain version.

``bin_sort_grouped`` is the counterpart of ``cython3dmodelrenderer_tpu/
ops/binsort_pallas.py::bin_sort_grouped`` (``:361``; TPU kernel
``_make_group_kernel``, ``:106``), with the same outputs: ``order``,
``gstarts``, ``gchunks``, ``stids``, ``sstripes``, ``tile_counts``,
``total_slots`` and ``n_active``. A "group" is ``group`` tiles sharing one
TPU raster step; each 128-slot chunk interleaves its tiles as ``sub``-lane
stripes, and the groups are composed of tiles sorted by stripe demand.

No render path of the port reaches it, as none of the JAX package does (it
is the JAX tests' oracle for ``bin_gather_grouped``): B1 reads exact
per-tile runs. It is here so that every Pallas kernel has a counterpart.

The glue is plain torch (``_group_tables``): per-tile pair counts by
``bincount`` (the integers of JAX's membership matmul), the count-sorted
group composition whose packed tile keys are sorted by B2 (``sort_i32``;
ROADMAP B6), the per-group capacity clamp, the pair expansion clamped at
``slot_cap`` with its sentinel tail, and each tile's placement base,
bound and chunk count. The placement itself — each pair's rank among the
earlier pairs of its tile, and its slot — is ``csrc/binsort_grouped.cu``
on a CUDA tensor and ``bin_sort_grouped_plain`` on a CPU tensor.

Unplaced slots: JAX leaves them uninitialised and clips ``order`` to
``[0, t]``; the port fills them with ``t``, inside that range.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Tuple

import torch

from .. import cuda_build
from .binsort import _check_spans, expand_pairs
from .sort import sort_i32, sort_i32_plain

TRI_BITS = 17                 # pair key: (tri << 14) | tile, 17 + 14 bits
TILE_BITS = 14
#: B5's per-block cursor table holds at most this many int32 entries (64 MB)
TABLE_ENTRIES = 1 << 24
#: fewest consecutive pairs one B5 block places (its warp's walk)
MIN_BLOCK_PAIRS = 128

Grouped = Tuple[torch.Tensor, ...]


def block_split(n_items: int, n_cols: int) -> Tuple[int, int]:
    """(blocks, items per block) of B5's passes: blocks of at least
    ``MIN_BLOCK_PAIRS`` consecutive pairs, as many as the cursor table's
    ``TABLE_ENTRIES`` allow (a block's walk is sequential, so more blocks
    shorten the critical path)."""
    blocks = max(1, min(n_items // MIN_BLOCK_PAIRS,
                        TABLE_ENTRIES // max(1, n_cols)))
    per_block = -(-n_items // blocks)
    return -(-n_items // per_block), per_block


def _check_limits(t: int, ntx: int, nty: int, slot_cap: int, group: int,
                  sub: int) -> None:
    """The JAX asserts (``binsort_pallas.py:378-396``): the packed pair
    ``(tri << 14) | tile`` reaches INT32_MAX exactly at 2^17 - 1 triangles
    and 2^14 - 1 tiles, so neither field may grow."""
    if group * sub != 128:
        raise ValueError(f"group * sub must be 128, got {group} * {sub}")
    if slot_cap % 128:
        raise ValueError(f"slot_cap {slot_cap} is not a multiple of 128")
    if ntx > 63 or ntx * nty >= (1 << TILE_BITS):
        raise ValueError(f"{ntx} x {nty} tiles: the packed bin descriptor "
                         "holds at most 63 tiles across and 2^14 - 1 tiles")
    if t >= (1 << TRI_BITS) or slot_cap >= (1 << TRI_BITS):
        raise ValueError(f"{t} triangles / {slot_cap} slots: pair packing "
                         "supports fewer than 2^17 of each")


def compose_groups(tile_counts: torch.Tensor, group: int, sub: int,
                   sort: Callable[[torch.Tensor, int], torch.Tensor] = sort_i32):
    """``_compose_groups`` (``binsort_pallas.py:271``): tiles sorted by
    descending stripe demand ``ceil(count / sub)``, ascending tile id
    within equal demand, in consecutive ``group``-tuples. The packed key
    ``(inv << 14) | tile`` is unique, so B2 (``sort``, on the key's 31
    bits) and ``torch.sort`` agree. Returns (stids, sstripes, gchunks),
    padded with the sentinel tile ``n_tiles`` to a multiple of
    ``group``."""
    n_tiles = tile_counts.numel()
    n_sorted = -(-n_tiles // group) * group
    dev = tile_counts.device
    stripes = (tile_counts + (sub - 1)) // sub
    inv = ((1 << TRI_BITS) - 1) - torch.clamp(stripes, max=(1 << TRI_BITS) - 1)
    key = ((inv << TILE_BITS)
           | torch.arange(n_tiles, dtype=torch.int32, device=dev)).to(torch.int32)
    skey = sort(key.contiguous(), TRI_BITS + TILE_BITS)
    stids = skey & ((1 << TILE_BITS) - 1)
    sstripes = ((1 << TRI_BITS) - 1) - (skey >> TILE_BITS)
    pad = n_sorted - n_tiles
    stids = torch.cat([stids, torch.full((pad,), n_tiles, dtype=torch.int32,
                                         device=dev)])
    sstripes = torch.cat([sstripes, torch.zeros(pad, dtype=torch.int32,
                                                device=dev)])
    return stids, sstripes, sstripes[::group].contiguous()


def clamp_group_chunks(gchunks: torch.Tensor, allowed: int):
    """``_clamp_group_chunks`` (``binsort_pallas.py:245``): trailing groups
    lose chunks past ``allowed``. Returns (gchunks, gstarts (n_groups + 1,
    in slots), total_slots (the unclamped demand, saturated below 2^31))."""
    csum = torch.cumsum(gchunks.to(torch.int64), 0)
    total_slots = (128 * torch.clamp(csum[-1], max=(1 << 24) - 1)).to(torch.int32)
    cum_c = torch.clamp(csum, max=allowed)
    start_c = torch.clamp(torch.cat([csum.new_zeros(1), csum[:-1]]), max=allowed)
    gstarts = 128 * torch.cat([start_c, cum_c[-1:]])
    return ((cum_c - start_c).to(torch.int32), gstarts.to(torch.int32),
            total_slots)


def _group_tables(tx0, cx, ty0, cy, ntx: int, nty: int, slot_cap: int,
                  group: int, sub: int, sort):
    """Everything but the placement: the JAX outputs other than ``order``,
    the packed pairs (slot_cap,) with the sentinel tail, the count of
    pairs that survive the clamp, and the per-tile base / bound / chunk
    count of the placement (n_tiles + 1 entries; entry n_tiles is the
    sentinel tile's: base 0, bound 0, one chunk)."""
    _check_spans(tx0, cx, ty0, cy)
    t = tx0.shape[0]
    _check_limits(t, ntx, nty, slot_cap, group, sub)
    dev = tx0.device
    n_tiles = ntx * nty
    total = int((cx.to(torch.int64) * cy).sum())         # one host read
    tri_p, tile_p = expand_pairs(tx0, cx, ty0, cy, ntx, total)
    tile_counts = torch.bincount(tile_p.to(torch.int64), minlength=n_tiles)
    tile_counts = tile_counts.to(torch.int32)
    stids, sstripes, gchunks = compose_groups(tile_counts, group, sub, sort)
    gchunks, gstarts, total_slots = clamp_group_chunks(gchunks, slot_cap // 128)

    n_pairs = min(total, slot_cap)
    pairs = torch.full((slot_cap,), n_tiles, dtype=torch.int32, device=dev)
    pairs[:n_pairs] = (tri_p[:n_pairs] << TILE_BITS) | tile_p[:n_pairs]

    k = torch.arange(n_tiles, device=dev)
    g = k // group
    tiles = stids[:n_tiles].to(torch.int64)
    base = torch.zeros(n_tiles + 1, dtype=torch.int32, device=dev)
    bound = torch.zeros_like(base)
    blocks = torch.ones_like(base)
    base[tiles] = (gstarts[g] + k % group).to(torch.int32)
    bound[tiles] = gstarts[g + 1]
    blocks[tiles] = torch.clamp((gstarts[g + 1] - gstarts[g]) // (group * sub),
                                min=1)
    n_active = (tile_counts > 0).sum(dtype=torch.int32)
    outputs = (gstarts, gchunks, stids, sstripes, tile_counts, total_slots,
               n_active)
    return outputs, pairs, n_pairs, (base, bound, blocks)


def bin_sort_grouped_plain(tx0: torch.Tensor, cx: torch.Tensor,
                           ty0: torch.Tensor, cy: torch.Tensor, ntx: int,
                           nty: int, slot_cap: int, group: int = 8,
                           sub: int = 16) -> Grouped:
    """The plain version of ``bin_sort_grouped``: ranks from a stable sort
    of the surviving pairs' tiles, the slots in closed form, one masked
    scatter."""
    outputs, pairs, n_pairs, (base, bound, blocks) = _group_tables(
        tx0, cx, ty0, cy, ntx, nty, slot_cap, group, sub, sort_i32_plain)
    order = torch.full((slot_cap,), tx0.shape[0], dtype=torch.int32,
                       device=tx0.device)
    live = pairs[:n_pairs]
    tile = (live & ((1 << TILE_BITS) - 1)).to(torch.int64)
    by_tile = torch.sort(tile, stable=True).indices
    counts = torch.bincount(tile, minlength=base.numel())
    first = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(tile)
    rank[by_tile] = torch.arange(n_pairs, device=tile.device) - first[tile[by_tile]]
    b = blocks[tile].to(torch.int64)
    pos = base[tile] + (rank % b) * (group * sub) + (rank // b) * group
    ok = (pos < bound[tile]) & (rank < b * sub)
    order[pos[ok]] = live[ok] >> TILE_BITS
    return (order,) + outputs


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("binsort_grouped")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.group_count_launch.argtypes = [p, i, i, i, p, i, p]
    lib.group_place_launch.argtypes = [p, i, i, i, p, p, p, p, i, i, p, i, p]
    lib.group_count_launch.restype = ctypes.c_int
    lib.group_place_launch.restype = ctypes.c_int
    return lib


def bin_sort_grouped(tx0: torch.Tensor, cx: torch.Tensor, ty0: torch.Tensor,
                     cy: torch.Tensor, ntx: int, nty: int, slot_cap: int,
                     group: int = 8, sub: int = 16) -> Grouped:
    """Counting-sort triangles into group-interleaved, count-sorted bins.

    ``tx0, cx, ty0, cy`` (T,) int32 tile spans on the ``ntx x nty`` grid.
    Returns (order (slot_cap,) int32 — the triangle id at each slot, ``T``
    where no pair was placed —, gstarts (n_groups + 1,) in slots, gchunks
    (n_groups,), stids and sstripes (n_sorted,), tile_counts (n_tiles,),
    total_slots and n_active (0-dim)), bit-equal to JAX's on the placed
    slots and in every table, under capacity overflow too. A pair of tile
    t with rank r lands at ``base[t] + (r % b)·group·sub + (r // b)·group``
    (b = its group's chunk count) if that is below its group's bound and
    ``r < b·sub``. CUDA tensors launch kernel B5, CPU tensors run
    ``bin_sort_grouped_plain``; any other device raises.
    """
    _check_spans(tx0, cx, ty0, cy)
    if tx0.device.type == "cpu":
        return bin_sort_grouped_plain(tx0, cx, ty0, cy, ntx, nty, slot_cap,
                                      group, sub)
    if tx0.device.type != "cuda":
        raise ValueError(f"bin_sort_grouped: unsupported device {tx0.device}")
    dev = tx0.device
    outputs, pairs, n_pairs, (base, bound, blocks) = _group_tables(
        tx0, cx, ty0, cy, ntx, nty, slot_cap, group, sub, sort_i32)
    order = torch.full((slot_cap,), tx0.shape[0], dtype=torch.int32, device=dev)
    if n_pairs == 0:
        return (order,) + outputs
    n_cols = base.numel()
    nblocks, per_block = block_split(n_pairs, n_cols)
    lib = _lib()
    stream = cuda_build.stream_handle(dev)
    table = torch.zeros((nblocks, n_cols), dtype=torch.int32, device=dev)
    err = lib.group_count_launch(pairs.data_ptr(), n_pairs, per_block, n_cols,
                                 table.data_ptr(), dev.index, stream)
    cuda_build.check(lib, err, "bin_sort_grouped pass A "
                     "(csrc/binsort_grouped.cu)")
    cursors = torch.cumsum(table, 0, dtype=torch.int32)  # exclusive column scan
    cursors -= table
    del table
    err = lib.group_place_launch(pairs.data_ptr(), n_pairs, per_block, n_cols,
                                 cursors.data_ptr(), base.data_ptr(),
                                 bound.data_ptr(), blocks.data_ptr(), group,
                                 sub, order.data_ptr(), dev.index, stream)
    cuda_build.check(lib, err, "bin_sort_grouped pass B "
                     "(csrc/binsort_grouped.cu)")
    bin_sort_grouped.launches += 1
    return (order,) + outputs


#: kernel launches made by ``bin_sort_grouped`` (one per call that places
#: pairs on a CUDA tensor)
bin_sort_grouped.launches = 0
