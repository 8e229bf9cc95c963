"""Explicit device resolution.

Nothing in the port picks a device on its own: ``None`` means the CPU, and
asking for a CUDA device that is not there raises instead of falling back.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → CPU; ``"cuda"``/``"cuda:N"``/``torch.device`` as given.

    Raises ``RuntimeError`` for a CUDA device when CUDA is unavailable.
    """
    dev = torch.device("cpu") if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not available")
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
