"""What both drivers hand the program and the reference: the program's
``Renderer`` for a configuration, and a state's arrays on the device."""
from __future__ import annotations

import numpy as np
import torch


def program_renderer(camera: dict, size: int, direction, device):
    """The port's ``Renderer`` over an ``AdvancedPixelBufferFiller`` at
    ``size``², lit by ``GuroIllumination(direction)`` or unlit."""
    import cython3dmodelrenderer_tpu_torch as program

    filler = program.AdvancedPixelBufferFiller(
        size, size, fov=camera["fov"], z_near=camera["z_near"],
        z_far=camera["z_far"], device=device)
    illumination = (program.GuroIllumination(direction)
                    if direction is not None else program.NoIllumination())
    return program, program.Renderer(filler, illumination,
                                      program.SimpleIterator, size, size,
                                      device=device)


def reference_arrays(state: dict, device) -> list:
    """(vertices, faces, normals, colors) of a state as tensors on
    ``device``, in ``render.render_view``'s order."""
    return [torch.from_numpy(np.ascontiguousarray(state[k])).to(device)
            for k in ("vertices", "faces_v", "normals", "colors")]
