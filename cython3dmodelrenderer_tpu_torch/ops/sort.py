"""Ascending sort of non-negative int32 keys — kernel B2 and its plain version.

``sort_i32`` replaces ``cython3dmodelrenderer_tpu/ops/sort_pallas.py::
bitonic_sort_i32`` (TPU kernel ``_make_kernel``, ``sort_pallas.py:32``). On
a CUDA tensor it launches the bitonic kernel of ``csrc/sort.cu`` (one
shared-memory block up to 2^15 keys, global merge passes above that; see the
source for what bounds it); on a CPU tensor it runs ``sort_i32_plain``. The
frame uses it for the packed (tile, triangle) pair keys.
"""
from __future__ import annotations

import ctypes

import torch

from .. import cuda_build

INT32_MAX = 2 ** 31 - 1


def sort_i32_plain(keys: torch.Tensor) -> torch.Tensor:
    """The plain version: ``torch.sort``."""
    return torch.sort(keys).values


def _check(keys: torch.Tensor) -> None:
    if keys.dtype != torch.int32 or keys.dim() != 1 or not keys.is_contiguous():
        raise ValueError("sort_i32 takes a contiguous 1-D int32 tensor, got "
                         f"{keys.dtype} of shape {tuple(keys.shape)}")


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("sort")
    lib.sort_i32_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p]
    lib.sort_i32_launch.restype = ctypes.c_int
    return lib


def sort_i32(keys: torch.Tensor) -> torch.Tensor:
    """Ascending sort of a 1-D tensor of non-negative int32 keys.

    CUDA tensors go through kernel B2 (the keys are copied into a scratch
    buffer padded to a power of two with INT32_MAX); CPU tensors through
    ``sort_i32_plain``. Any other device raises.
    """
    _check(keys)
    if keys.device.type == "cpu":
        return sort_i32_plain(keys)
    if keys.device.type != "cuda":
        raise ValueError(f"sort_i32: unsupported device {keys.device}")
    n0 = keys.numel()
    if n0 == 0:
        return keys.clone()
    n = 1 << max(1, (n0 - 1).bit_length())
    buf = torch.full((n,), INT32_MAX, dtype=torch.int32, device=keys.device)
    buf[:n0].copy_(keys)
    lib = _lib()
    err = lib.sort_i32_launch(buf.data_ptr(), n, keys.device.index,
                              cuda_build.stream_handle(keys.device))
    cuda_build.check(lib, err, "sort_i32 (csrc/sort.cu)")
    sort_i32.launches += 1
    return buf[:n0]


#: kernel launches made by ``sort_i32`` (one per call on a CUDA tensor)
sort_i32.launches = 0
