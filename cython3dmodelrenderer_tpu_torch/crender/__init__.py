"""Drop-in namespace for code written against the reference ``crender``.

Counterpart of the repository's ``crender/`` (which maps onto the JAX
package): ``crender.py`` (the reference's pure-NumPy tree) and
``crender.cy`` (its compiled tree) both map onto this port's classes,
which run on the card unless given ``device="cpu"``. The top-level
``Renderer`` is the py one, as in the reference (``crender/__init__.py``).
"""
from . import cy, py
from .py import Renderer

__all__ = ["py", "cy", "Renderer"]
