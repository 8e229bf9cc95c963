"""Device mesh construction over ``torch.distributed``.

Counterpart of ``cython3dmodelrenderer_tpu/parallel/mesh.py``. JAX builds
one program's mesh from the devices it sees; here every rank is its own
process, so the mesh spans the ranks of the default process group, which
the caller initializes (backend, address, world size and rank are the
caller's choice; ``make_mesh`` picks none of them).
"""
from __future__ import annotations

import math
import os
from typing import Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import resolve_device


def make_mesh(axis_shapes: Sequence[Tuple[str, int]], device=None) -> DeviceMesh:
    """A named mesh over every rank, e.g. ``make_mesh([("views", 4),
    ("tris", 2)])``.

    ``device`` as ``device.resolve_device``: the card unless ``"cpu"`` is
    given, and without CUDA that raises. On CUDA each rank selects
    ``cuda:(local_rank % device_count)``, ``local_rank`` being
    ``$LOCAL_RANK`` when a launcher sets it, else the global rank. The
    product of the axis sizes must equal the world size (JAX takes the
    first n devices; a process group cannot leave ranks out).
    """
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the default process group: call "
                           "torch.distributed.init_process_group first")
    names = tuple(name for name, _ in axis_shapes)
    shape = tuple(int(size) for _, size in axis_shapes)
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {dict(zip(names, shape))} needs "
                         f"{math.prod(shape)} ranks, the world has {world}")
    if dev.type == "cuda":
        local_rank = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    return init_device_mesh(dev.type, shape, mesh_dim_names=names)
