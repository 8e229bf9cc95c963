"""The comparison that decides ``correct``: pixels of a delivered image
that differ from the reference's.

A pixel counts when any of its three channels differs. An image of
another shape than the reference's counts every reference pixel, and a
missing image counts as an image of another shape.
"""
from __future__ import annotations

import torch

#: the limit of each number compared (see PERF.md for the readings they
#: were set from): the worst delivered image's mismatched pixels, and the
#: images due that no step delivered
LIMITS = {"worst_image_px": 0, "images_missing": 0}


def mismatched_pixels(image, reference: torch.Tensor) -> int:
    """Pixels of ``image`` (H, W, 3) uint8 that differ from ``reference``."""
    pixels = reference.shape[0] * reference.shape[1]
    if image is None or tuple(image.shape) != tuple(reference.shape):
        return pixels
    differ = (image.to(reference.device) != reference).any(dim=-1)
    return int(differ.sum())
