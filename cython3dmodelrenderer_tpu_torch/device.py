"""Explicit device resolution.

The port's entry points run on the card unless the caller asks for the
CPU: ``None`` means the current CUDA device, and without CUDA that raises
instead of falling back. ``"cpu"`` is the only way onto the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → the current CUDA device; ``"cpu"``, ``"cuda"``,
    ``"cuda:N"`` or a ``torch.device`` as given.

    Raises ``RuntimeError`` for ``None`` or a CUDA device when CUDA is
    unavailable.
    """
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               "available (pass device='cpu' for the CPU)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def resolve_backend(backend: str, device: torch.device) -> str:
    """Map a config backend onto ``"cuda"`` (kernels) or ``"torch"`` (plain)."""
    if backend == "auto":
        return "cuda" if device.type == "cuda" else "torch"
    if backend == "cuda" and device.type != "cuda":
        raise ValueError("backend='cuda' needs a CUDA device")
    if backend not in ("cuda", "torch"):
        raise ValueError(f"unknown backend {backend!r}")
    return backend
