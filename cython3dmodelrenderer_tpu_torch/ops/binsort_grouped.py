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

Each pair's rank among the earlier pairs of its tile is what B4's stable
bins give (``binsort.bin_sort``): the pair at bin slot j of tile t has rank
``j - tile_starts[t]``. So on a CUDA tensor B5 is B4, then
``csrc/binsort_grouped.cu``: the tile keys, B2's sort of them (``sort_i32``,
31 bits; ROADMAP B6), one block of tables (composition, chunk clamp,
per-tile base / bound / blocks, the expansion's cut) and one placement
thread a binned pair. ``place_from_bins_plain`` is that decomposition in
plain torch on ``bin_sort_plain``'s bins; ``bin_sort_grouped_plain``, the
plain version of the whole wrapper, ranks by a stable sort of the
expanded pairs instead.

The clamp: JAX places only the first ``n_pairs = min(total, slot_cap)``
pairs of the expansion (triangle, then its tiles row-major). The pairs it
drops are the tail of every bin they are in, so the others keep their
ranks. With tc the triangle whose span holds pair ``n_pairs``
(``clamp_cut``), a binned pair (tri, tile) survives iff ``tri < tc``, or
``tri == tc`` and its row-major index in tc's span is below ``n_pairs -
prefix[tc]``.

Unplaced slots: JAX leaves them uninitialised and clips ``order`` to
``[0, t]``; the port fills them with ``t``, inside that range.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import cuda_build
from .binsort import Bins, _check_spans, bin_sort, bin_sort_plain, expand_pairs
from .sort import sort_i32, sort_i32_plain

TRI_BITS = 17                 # pair key: (tri << 14) | tile, 17 + 14 bits
TILE_BITS = 14

Grouped = Tuple[torch.Tensor, ...]


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


def compose_groups(tile_counts: torch.Tensor, group: int, sub: int):
    """``_compose_groups`` (``binsort_pallas.py:271``), plain: tiles sorted
    by descending stripe demand ``ceil(count / sub)``, ascending tile id
    within equal demand, in consecutive ``group``-tuples, by ``torch.sort``
    of the packed key ``(inv << 14) | tile`` (unique, 31 bits; the CUDA
    path sorts the same keys with B2). Returns (stids, sstripes, gchunks),
    padded with the sentinel tile ``n_tiles`` to a multiple of
    ``group``."""
    n_tiles = tile_counts.numel()
    n_sorted = -(-n_tiles // group) * group
    dev = tile_counts.device
    stripes = (tile_counts + (sub - 1)) // sub
    inv = ((1 << TRI_BITS) - 1) - torch.clamp(stripes, max=(1 << TRI_BITS) - 1)
    key = ((inv << TILE_BITS)
           | torch.arange(n_tiles, dtype=torch.int32, device=dev)).to(torch.int32)
    skey = sort_i32_plain(key.contiguous(), TRI_BITS + TILE_BITS)
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


def group_tables_plain(tile_counts: torch.Tensor, slot_cap: int, group: int,
                       sub: int):
    """Everything but ``order`` from the per-tile pair counts: the JAX
    outputs (gstarts, gchunks, stids, sstripes, tile_counts, total_slots,
    n_active) and each tile's placement base / bound / chunk count (n_tiles
    + 1 entries; entry n_tiles is the sentinel tile's: base 0, bound 0, one
    chunk). ``group_tables_kernel`` computes the same."""
    n_tiles = tile_counts.numel()
    dev = tile_counts.device
    stids, sstripes, gchunks = compose_groups(tile_counts, group, sub)
    gchunks, gstarts, total_slots = clamp_group_chunks(gchunks, slot_cap // 128)
    k = torch.arange(n_tiles, device=dev)
    g = k // group
    tiles = stids[:n_tiles].to(torch.int64)
    base = torch.zeros(n_tiles + 1, dtype=torch.int32, device=dev)
    bound = torch.zeros_like(base)
    blocks = torch.ones_like(base)
    base[tiles] = (gstarts[g] + k % group).to(torch.int32)
    bound[tiles] = gstarts[g + 1]
    blocks[tiles] = torch.clamp((gstarts[g + 1] - gstarts[g]) // (group * sub),
                                min=1).to(torch.int32)
    n_active = (tile_counts > 0).sum(dtype=torch.int32)
    outputs = (gstarts, gchunks, stids, sstripes, tile_counts, total_slots,
               n_active)
    return outputs, (base, bound, blocks)


def clamp_cut(cx: torch.Tensor, cy: torch.Tensor, n_pairs: int
              ) -> Tuple[int, int]:
    """(tc, keep): the triangle whose span holds expansion pair ``n_pairs``
    and the number of its pairs before it — the first triangle whose
    inclusive pair prefix passes ``n_pairs``. ``(len(cx), 0)`` when every
    pair is kept. ``group_tables_kernel`` computes the same on the card."""
    pc = cx.to(torch.int64) * cy
    inclusive = torch.cumsum(pc, 0)
    if inclusive.numel() == 0 or int(inclusive[-1]) <= n_pairs:
        return cx.numel(), 0
    tc = int(torch.searchsorted(inclusive, n_pairs, right=True))
    return tc, n_pairs - int(inclusive[tc] - pc[tc])


def _place(order, pair_tri, tile, rank, live, base, bound, blocks, group, sub):
    """Store each live pair's triangle at its slot under both guards."""
    b = blocks[tile].to(torch.int64)
    pos = base[tile] + (rank % b) * (group * sub) + (rank // b) * group
    ok = live & (pos < bound[tile]) & (rank < b * sub)
    order[pos[ok]] = pair_tri[ok]
    return order


def place_from_bins_plain(bins: Bins, tx0: torch.Tensor, cx: torch.Tensor,
                          ty0: torch.Tensor, cy: torch.Tensor, ntx: int,
                          nty: int, slot_cap: int, group: int = 8,
                          sub: int = 16) -> Grouped:
    """B5 as the CUDA path computes it, in plain torch: the tables from
    ``bins``' tile counts, each binned pair's rank ``j - tile_starts[t]``,
    the cut (``clamp_cut``) and the placement. ``bins`` are B4's
    (``bin_sort`` or ``bin_sort_plain``) on these spans."""
    _check_spans(tx0, cx, ty0, cy)
    _check_limits(tx0.shape[0], ntx, nty, slot_cap, group, sub)
    pair_tri, starts, counts = bins
    dev = tx0.device
    outputs, (base, bound, blocks) = group_tables_plain(counts, slot_cap,
                                                        group, sub)
    total = pair_tri.numel()
    tc, keep = clamp_cut(cx, cy, min(total, slot_cap))
    tile = torch.repeat_interleave(torch.arange(ntx * nty, device=dev),
                                   counts.to(torch.int64), output_size=total)
    rank = torch.arange(total, device=dev) - starts[tile]
    tri = pair_tri.to(torch.int64)
    index = ((tile // ntx - ty0[tri]) * cx[tri] + tile % ntx - tx0[tri])
    live = (tri < tc) | ((tri == tc) & (index < keep))
    order = torch.full((slot_cap,), tx0.shape[0], dtype=torch.int32,
                       device=dev)
    return (_place(order, pair_tri, tile, rank, live, base, bound, blocks,
                   group, sub),) + outputs


def bin_sort_grouped_plain(tx0: torch.Tensor, cx: torch.Tensor,
                           ty0: torch.Tensor, cy: torch.Tensor, ntx: int,
                           nty: int, slot_cap: int, group: int = 8,
                           sub: int = 16) -> Grouped:
    """The plain version of ``bin_sort_grouped``: the first ``n_pairs``
    expanded pairs, ranks from a stable sort of their tiles, the slots in
    closed form, one masked scatter."""
    _check_spans(tx0, cx, ty0, cy)
    t = tx0.shape[0]
    _check_limits(t, ntx, nty, slot_cap, group, sub)
    dev = tx0.device
    n_tiles = ntx * nty
    total = int((cx.to(torch.int64) * cy).sum())
    tri_p, tile_p = expand_pairs(tx0, cx, ty0, cy, ntx, total)
    tile_counts = torch.bincount(tile_p.to(torch.int64), minlength=n_tiles)
    outputs, (base, bound, blocks) = group_tables_plain(
        tile_counts.to(torch.int32), slot_cap, group, sub)
    n_pairs = min(total, slot_cap)
    tile = tile_p[:n_pairs].to(torch.int64)
    by_tile = torch.sort(tile, stable=True).indices
    kept = torch.bincount(tile, minlength=n_tiles)
    first = torch.cumsum(kept, 0) - kept
    rank = torch.empty_like(tile)
    rank[by_tile] = torch.arange(n_pairs, device=dev) - first[tile[by_tile]]
    order = torch.full((slot_cap,), t, dtype=torch.int32, device=dev)
    live = torch.ones(n_pairs, dtype=torch.bool, device=dev)
    return (_place(order, tri_p[:n_pairs], tile, rank, live, base, bound,
                   blocks, group, sub),) + outputs


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("binsort_grouped")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.group_keys_launch.argtypes = [p, i, i, p, p, i, i, i, p]
    lib.group_tables_launch.argtypes = ([p, p, i, i, i, i, i, i, p, p, i]
                                        + [p] * 10 + [i, p])
    lib.bin_place_launch.argtypes = [p, p, i, i, i, p, p, p, p, p, p, p,
                                     i, i, i, p, i, p]
    for fn in (lib.group_keys_launch, lib.group_tables_launch,
               lib.bin_place_launch):
        fn.restype = ctypes.c_int
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
    ``r < b·sub``. CUDA tensors run B4 (``bin_sort``) and kernel B5 (module
    docstring): one host read of the pair total, then ``bin_sort``, the
    keys, B2, the tables and the placement; CPU tensors run
    ``bin_sort_grouped_plain``; any other device raises.
    """
    _check_spans(tx0, cx, ty0, cy)
    if tx0.device.type == "cpu":
        return bin_sort_grouped_plain(tx0, cx, ty0, cy, ntx, nty, slot_cap,
                                      group, sub)
    if tx0.device.type != "cuda":
        raise ValueError(f"bin_sort_grouped: unsupported device {tx0.device}")
    t = tx0.shape[0]
    _check_limits(t, ntx, nty, slot_cap, group, sub)
    dev = tx0.device
    n_tiles = ntx * nty
    n_groups = -(-n_tiles // group)
    total = int(torch.sum(cx * cy, dtype=torch.int64))    # one host read
    pair_tri, starts, counts = bin_sort(tx0, cx, ty0, cy, ntx, nty, total)
    sizes = (slot_cap, n_tiles, n_groups + 1, n_groups, n_groups * group,
             n_groups * group, 1, 1, n_tiles + 1, n_tiles + 1, n_tiles + 1, 2)
    (order, keys, gstarts, gchunks, stids, sstripes, total_slots, n_active,
     base, bound, blocks, cut) = torch.empty(
         sum(sizes), dtype=torch.int32, device=dev).split(sizes)
    lib = _lib()
    stream = cuda_build.stream_handle(dev)
    err = lib.group_keys_launch(counts.data_ptr(), n_tiles, sub,
                                keys.data_ptr(), order.data_ptr(), slot_cap,
                                t, dev.index, stream)
    cuda_build.check(lib, err, "bin_sort_grouped keys (csrc/binsort_grouped.cu)")
    skey = sort_i32(keys, TRI_BITS + TILE_BITS)
    n_pairs = min(total, slot_cap)
    err = lib.group_tables_launch(
        skey.data_ptr(), counts.data_ptr(), n_tiles, group, sub, slot_cap,
        n_pairs, total, cx.data_ptr(), cy.data_ptr(), t,
        *(a.data_ptr() for a in (stids, sstripes, gchunks, gstarts,
                                 total_slots, n_active, base, bound, blocks,
                                 cut)), dev.index, stream)
    cuda_build.check(lib, err, "bin_sort_grouped tables "
                     "(csrc/binsort_grouped.cu)")
    if total > 0:
        err = lib.bin_place_launch(
            pair_tri.data_ptr(), starts.data_ptr(), total, n_tiles, ntx,
            tx0.data_ptr(), ty0.data_ptr(), cx.data_ptr(), cut.data_ptr(),
            base.data_ptr(), bound.data_ptr(), blocks.data_ptr(), group, sub,
            slot_cap, order.data_ptr(), dev.index, stream)
        cuda_build.check(lib, err, "bin_sort_grouped placement "
                         "(csrc/binsort_grouped.cu)")
        bin_sort_grouped.launches += 1
    return (order, gstarts, gchunks, stids, sstripes, counts,
            total_slots.reshape(()), n_active.reshape(()))


#: placement-kernel launches made by ``bin_sort_grouped`` (one per call on
#: a CUDA tensor with pairs)
bin_sort_grouped.launches = 0
