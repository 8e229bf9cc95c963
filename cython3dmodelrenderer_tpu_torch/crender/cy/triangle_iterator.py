from ...models.iterators import DepthIterator, SimpleIterator, TriangleIterator

__all__ = ["TriangleIterator", "SimpleIterator", "DepthIterator"]
