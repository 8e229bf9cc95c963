"""Triangle iterators — streaming order over a model's triangles.

Counterpart of ``cython3dmodelrenderer_tpu/models/iterators.py``:
``SimpleIterator`` (model order) and ``DepthIterator`` (ascending minimum
vertex z, stable — reference ``depth/depth_iterator.py:10-11``). The batched
render consumes the order as a permutation (``order_indices``); the
``__iter__`` protocol stays for reference-style per-triangle use.
"""
from __future__ import annotations

from abc import abstractmethod

import torch

from .model import Model


class TriangleIterator:
    def __init__(self, model: Model):
        self._model = model
        self._counter = 0
        self._n_triangles = model.n_triangles()

    def __len__(self):
        return self._n_triangles

    def __iter__(self):
        return self

    @abstractmethod
    def _index(self, i: int) -> int:
        ...

    def __next__(self):
        if self._counter >= self._n_triangles:
            raise StopIteration("There are no triangles left in the model.")
        tri = self._model.get_triangle(self._index(self._counter))
        self._counter += 1
        return tri

    @classmethod
    def order_indices(cls, model: Model) -> torch.Tensor:
        """Permutation of [0, T) giving this iterator's triangle order."""
        raise NotImplementedError


class SimpleIterator(TriangleIterator):
    def _index(self, i: int) -> int:
        return i

    @classmethod
    def order_indices(cls, model: Model) -> torch.Tensor:
        return torch.arange(model.n_triangles(), dtype=torch.int32,
                            device=model.device)


class DepthIterator(TriangleIterator):
    def __init__(self, model: Model):
        super().__init__(model)
        self._order = self.order_indices(model).tolist()

    def _index(self, i: int) -> int:
        return self._order[i]

    @classmethod
    def order_indices(cls, model: Model) -> torch.Tensor:
        min_z = model.vertices_by_triangles[:, :, 2].min(dim=1).values
        return torch.argsort(min_z, stable=True).to(torch.int32)
