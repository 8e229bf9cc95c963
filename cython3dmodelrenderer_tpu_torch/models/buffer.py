"""Image / depth / normal buffers — device-resident tensor wrappers.

Counterpart of ``cython3dmodelrenderer_tpu/models/buffer.py`` with the
reference ``Buffer`` API (``crender/py/data_structures/buffer.py:7-78``):
``get/set_pixel``, ``clear``, ``get_size``, ``get_image``, ``write_to_file``
(vertical flip on write, OpenCV BGR), ``__getitem__``/``__setitem__``. The
backing tensor lives on the buffer's ``device``; host copies happen only in
the NumPy-returning accessors. Writes update the tensor in place.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..device import resolve_device

_DTYPES = {"uint8": torch.uint8, "float32": torch.float32,
           "int32": torch.int32, "float64": torch.float64}


class Buffer:
    def __init__(self, height: int, width: int, dim: int = 3,
                 dtype: str = "float32", init_val=0, device=None):
        if dtype not in _DTYPES:
            raise ValueError(f"unsupported buffer dtype {dtype!r}")
        self._height = height
        self._width = width
        self._dim = dim
        self._dtype = dtype
        self._init_val = init_val
        self._device = resolve_device(device)
        self._buffer: torch.Tensor = None  # set by clear()
        self._pending = None               # lazy thunk (see set_lazy)
        self.clear()

    # -- lazy contents -----------------------------------------------------

    def set_lazy(self, thunk) -> None:
        """Defer this buffer's contents: ``thunk()`` runs once, on first
        access, and must return the (H, W, dim) tensor."""
        self._pending = thunk

    def _settle(self) -> None:
        if self._pending is not None:
            thunk, self._pending = self._pending, None
            self.array = thunk()

    # -- array-style access ------------------------------------------------

    def __getitem__(self, val) -> np.ndarray:
        self._settle()
        return self._buffer.cpu().numpy()[val]

    def __setitem__(self, key, value) -> None:
        self._settle()
        self._buffer[key] = torch.as_tensor(np.asarray(value),
                                            device=self._device).to(self._buffer.dtype)

    # -- device-side API ---------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def array(self) -> torch.Tensor:
        """The raw device tensor (no host transfer)."""
        self._settle()
        return self._buffer

    @array.setter
    def array(self, value: torch.Tensor) -> None:
        shape = (self._height, self._width, self._dim)
        if tuple(value.shape) != shape:
            raise ValueError(f"expected {shape}, got {tuple(value.shape)}")
        self._pending = None
        self._buffer = value.to(device=self._device, dtype=_DTYPES[self._dtype])

    # -- reference-compatible API -----------------------------------------

    def write_to_file(self, filename: str) -> None:
        # Row flip on write, like the reference (buffer.py:54-55): the
        # render uses a y-up screen space, image files are y-down.
        import cv2

        cv2.imwrite(filename, self.get_image()[::-1])

    def get_pixel(self, x: int, y: int) -> np.ndarray:
        self._settle()
        return self._buffer[y, x].cpu().numpy()

    def get_size(self) -> Tuple[int, int]:
        return self._height, self._width

    def get_image(self) -> np.ndarray:
        self._settle()
        return self._buffer.cpu().numpy()

    def set_pixel(self, x: int, y: int, value) -> None:
        # bounds-checked silent drop, like the reference (buffer.py:66-69)
        if x not in range(self._width) or y not in range(self._height):
            return
        self[y, x] = value

    def clear(self) -> None:
        self._pending = None
        self._buffer = torch.full((self._height, self._width, self._dim),
                                  self._init_val, dtype=_DTYPES[self._dtype],
                                  device=self._device)

    # -- persistence --------------------------------------------------------

    def save(self, filename: str) -> None:
        """Checkpoint the buffer (lossless, dtype-preserving .npz)."""
        np.savez(filename, buffer=self.get_image(), init_val=self._init_val)

    @classmethod
    def load(cls, filename: str, device=None) -> "Buffer":
        """Restore a buffer checkpointed with :meth:`save`."""
        with np.load(filename) as data:
            arr = data["buffer"]
            buf = cls(arr.shape[0], arr.shape[1], dim=arr.shape[2],
                      dtype=str(arr.dtype), init_val=data["init_val"].item(),
                      device=device)
        buf._buffer = torch.as_tensor(arr, device=buf._device)
        return buf
