"""Ascending sort of non-negative int32 keys — kernel B2, its plain version,
and the pass planner of the radix-sort core that B2 and B4 share.

``sort_i32`` replaces ``cython3dmodelrenderer_tpu/ops/sort_pallas.py::
bitonic_sort_i32`` (TPU kernel ``_make_kernel``, ``sort_pallas.py:32``). On
a CUDA tensor it launches the stable LSD radix sort of
``csrc/radix_sort.cu`` on the keys' ``bits`` low bits, with no padding (see
the source for the design and what bounds it); on a CPU tensor it runs
``sort_i32_plain``. The frame uses it for the packed (tile, triangle) pair
keys; ``binsort.bin_sort`` (B4) runs the same core on tile ids.

``plan`` is what the wrappers size a launch with, mirroring the C
launchers: ``ceil(bits / 8)`` passes of 8-bit digits over ``TILE_KEYS``-key
tiles; up to ``ONE_LAUNCH_MAX_KEYS`` keys one cooperative launch (a CTA a
tile, grid barriers between passes), else the onesweep path with a zeroed
scratch of histograms, tickets and look-back words.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import cuda_build
from ..utils import timing

INT32_MAX = 2 ** 31 - 1
RADIX_BITS = 8
RADIX = 1 << RADIX_BITS
#: keys a tile (one CTA)
TILE_KEYS = 2048
#: the most keys the one-launch path sorts: 64 co-resident CTAs
ONE_LAUNCH_MAX_KEYS = 64 * TILE_KEYS


class SortPlan(NamedTuple):
    passes: int          # 8-bit digit passes
    one_launch: bool     # one cooperative launch (else onesweep)
    tiles: int           # TILE_KEYS-key tiles, one CTA each
    scratch_words: int   # int32 scratch: the tiles' counts (one launch), or
                         # zeroed histograms, tickets, look-back words
    launches: int        # device operations of B2's launcher (kernels, memset)


def plan(n: int, bits: int) -> SortPlan:
    """How the core sorts ``n`` keys of ``bits`` bits. The one launch keeps
    256 counts a tile; the onesweep scratch holds ``passes`` histograms of
    256 counts, ``passes`` tile tickets and ``passes x tiles x 256``
    look-back words, and its launches are the memset, the upsweep and one
    scatter a pass (B4 folds the upsweep into its expansion)."""
    if not 1 <= bits <= 31:
        raise ValueError(f"bits must be in [1, 31], got {bits}")
    passes = -(-bits // RADIX_BITS)
    tiles = -(-n // TILE_KEYS)
    if n <= ONE_LAUNCH_MAX_KEYS:
        return SortPlan(passes, True, tiles, tiles * RADIX, int(n > 0))
    return SortPlan(passes, False, tiles,
                    passes * (RADIX + 1) + passes * tiles * RADIX, 2 + passes)


def sort_i32_plain(keys: torch.Tensor, bits: int = 31) -> torch.Tensor:
    """The plain version: ``torch.sort``. ``bits`` is accepted so that both
    sorts share one signature; ``torch.sort`` needs no key width."""
    return torch.sort(keys).values


def _check(keys: torch.Tensor) -> None:
    if keys.dtype != torch.int32 or keys.dim() != 1 or not keys.is_contiguous():
        raise ValueError("sort_i32 takes a contiguous 1-D int32 tensor, got "
                         f"{keys.dtype} of shape {tuple(keys.shape)}")


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("radix_sort")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.radix_sort_launch.argtypes = [p, p, p, i, i, p, i, p]
    lib.radix_sort_launch.restype = ctypes.c_int
    lib.binsort_launch.argtypes = [p, p, p, p, i, i, i, i, i, p, p, p, i, p]
    lib.binsort_launch.restype = ctypes.c_int
    lib.radix_constants.argtypes = [p]
    lib.radix_constants.restype = None
    return lib


def core_constants() -> dict:
    """The built core's own constants, to hold ``plan``'s against (card)."""
    out = (ctypes.c_int * 5)()
    _lib().radix_constants(out)
    return dict(zip(("radix_bits", "tile_keys", "one_launch_max_keys",
                     "expand_tris", "scan_tiles"), out))


def sort_i32(keys: torch.Tensor, bits: int = 31) -> torch.Tensor:
    """Ascending sort of a 1-D tensor of int32 keys in ``[0, 2^bits)``.

    CUDA tensors go through kernel B2: ``ceil(bits / 8)`` stable radix
    passes, one launch up to ``ONE_LAUNCH_MAX_KEYS`` keys; the result is a
    new tensor of the keys' length. CPU tensors go through ``sort_i32_plain``.
    Any other device, or ``bits`` outside [1, 31], raises.
    """
    _check(keys)
    sort_plan = plan(keys.numel(), bits)
    if keys.device.type == "cpu":
        return sort_i32_plain(keys)
    if keys.device.type != "cuda":
        raise ValueError(f"sort_i32: unsupported device {keys.device}")
    n = keys.numel()
    if n == 0:
        return keys.clone()
    dev = keys.device
    out = torch.empty_like(keys)
    # the scratch, then n ping-pong keys
    work = torch.empty(sort_plan.scratch_words + n, dtype=torch.int32,
                       device=dev)
    lib = _lib()
    err = lib.radix_sort_launch(
        keys.data_ptr(), out.data_ptr(),
        work.data_ptr() + 4 * sort_plan.scratch_words, n, bits,
        work.data_ptr(), dev.index, cuda_build.stream_handle(dev))
    cuda_build.check(lib, err, "sort_i32 (csrc/radix_sort.cu)")
    timing.counters["launch.sort"] += 1
    return out
