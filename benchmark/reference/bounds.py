"""Frozen bound arithmetic: the card's peaks and each kernel's least time.

Copied from the program's measurement rules (``measure.py``,
``chip_smoke.py``'s bounds, ``ops/raster.py::walk_instructions``) and
frozen here, so that a later change to the program cannot move the
yardstick. Every count comes from the shapes a step has and from the
reference's own stats (``render.render_view``), never from the program.

A bound is the larger of the bytes moved over the memory rate and the f32
instructions over the instruction rate, in seconds.
"""
from __future__ import annotations

#: H100 SXM device-memory rate, bytes/s (data sheet)
HBM_BYTES_PER_S = 3.35e12
#: f32 instructions/s outside the tensor cores: 132 SMs x 128 lanes x the
#: 1.98 GHz boost clock. The data sheet's 67 TFLOP/s counts an FMA as two
#: operations; the program's kernels build with -fmad=false, so each
#: multiply, add, compare and select is one instruction at this rate.
F32_INSTR_PER_S = 33.5e12

TILE_H, TILE_W = 16, 32
#: the program's lane-subgroup packing, which routes a frame's bins
GROUP = 16
#: f32 instructions of the raster walk per (pair, pixel of its window)
RASTER_INSTR_PER_PIXEL = 28
#: F1's f32 instructions per (view, triangle): cull 12, projection 93,
#: λ planes 42, z plane 15, bbox and its rule 46, spans 12; 15 an attribute
#: channel, 99 for the pose
F1_BASE, F1_PER_CHANNEL, F1_POSE = 220, 15, 99


def seconds(bytes_moved: float, instructions: float) -> float:
    return max(bytes_moved / HBM_BYTES_PER_S, instructions / F32_INSTR_PER_S)


def row_width(n_attrs: int) -> int:
    """Floats in a plane row: 12 plane coefficients, the bbox, 3 a channel."""
    return 16 + 3 * n_attrs


def tiles(height: int, width: int):
    return -(-width // TILE_W), -(-height // TILE_H)


def f1(triangles: int, views: int, n_attrs: int, posed: bool) -> float:
    """F1: vertices, normals, colours and poses read once; rows, five span
    arrays and the int64 total written once (264 bytes a triangle at 6
    channels)."""
    n = views * triangles
    read = 36 * triangles * (2 + (n_attrs > 0)) + (48 * views if posed else 0)
    written = n * (4 * row_width(n_attrs) + 20) + 8
    instr = n * (F1_BASE + F1_PER_CHANNEL * n_attrs + F1_POSE * posed)
    return seconds(read + written, instr)


def sort_route(triangles: int, views: int, pairs: int, height: int,
               width: int) -> bool:
    """The program's route rule: a view batch inside the grouped budget
    (fewer than 2^17 stacked triangles and pairs, at most 63 tiles across,
    fewer than 2^14 tiles with each view's rows padded to a multiple of 16)
    takes the sort route, every other batch the counting sort."""
    ntx, nty = tiles(height, width)
    rows = views * (-(-nty // GROUP) * GROUP)
    return (views * triangles < (1 << 17) and pairs < (1 << 17) and ntx <= 63
            and ntx * rows < (1 << 14))


def binning(triangles: int, views: int, pairs: int, height: int,
            width: int) -> float:
    """The binning kernels. Sort route (B2): the packed pair keys read and
    written once, two instructions a key for each 8-bit pass of the key's
    triangle and tile bits. Counting route (B4): four span arrays read
    once, the pair list and two tile tables written once, two instructions
    a pair."""
    ntx, nty = tiles(height, width)
    n_tiles = views * ntx * nty
    if sort_route(triangles, views, pairs, height, width):
        bits = (max(1, (views * triangles - 1).bit_length())
                + max(1, (n_tiles - 1).bit_length()))
        return seconds(8 * pairs, 2 * pairs * -(-bits // 8))
    n = views * triangles
    return seconds(16 * n + 4 * pairs + 8 * n_tiles, 2 * pairs)


def raster(triangles: int, views: int, pairs: int, window_pixels: int,
           n_attrs: int, height: int, width: int) -> float:
    """B1: rows, pair list and tile tables read once, the uint8 image
    written once; 28 instructions for each pixel of each binned pair's
    window (its ceil bbox within its tile and the image)."""
    ntx, nty = tiles(height, width)
    n_tiles = views * ntx * nty
    read = (views * triangles * 4 * row_width(n_attrs) + 4 * pairs
            + 8 * n_tiles)
    return seconds(read + views * height * width * 3,
                   RASTER_INSTR_PER_PIXEL * window_pixels)
