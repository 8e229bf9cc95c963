"""Closed-loop single frames through ``Renderer.render``.

One user renders frame after frame. The traffic file gives the image
``size``, the number of posed copies (``poses``) and the turntable
jitter (``jitter_deg``): pose k turns the README pose by
``360 k / poses`` degrees plus a seeded jitter about y. Each copy is
handed to the program through ``Model.from_state`` at set-up, and the
loop cycles the copies in a seeded order, so no two consecutive frames
are alike. A step is one frame; its key is its pose.
"""
from __future__ import annotations

import numpy as np
import torch

from reference import bounds, meshes
from reference.render import frame_light, render_view
from scene import program_renderer, reference_arrays


class Driver:
    unit = "frame"
    images_per_key = 1
    #: device kernels a step launches once each
    kernels_per_step = {"frontend_kernel": 1, "raster_kernel": 1}

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        rng = np.random.default_rng(seed)
        n = int(traffic["poses"])
        jitter = float(traffic["jitter_deg"])
        angles = 360.0 * np.arange(n) / n + rng.uniform(-jitter, jitter, n)
        vertices, faces = meshes.build(config["mesh"])
        colors = meshes.seeded_colors(len(vertices), rng)
        self.states = meshes.posed_states(vertices, faces, config["pose"],
                                          angles, colors)
        self.order = rng.permutation(n)
        self.device = torch.device(device)
        self.size = int(traffic["size"])
        self.camera = dict(config["camera"], width=self.size, height=self.size)
        self.direction = config.get("light")
        self._render = None

    # -- the system under test ----------------------------------------
    def build_program(self) -> None:
        program, renderer = program_renderer(self.camera, self.size,
                                             self.direction, self.device)
        models = [program.Model.from_state(s, device=self.device)
                  for s in self.states]
        self._render = lambda k: renderer.render(models[k]).array

    def build_control(self, dtype: torch.dtype) -> None:
        """The reference in the program's place, computed in ``dtype``."""
        self._render = lambda k: self.reference(k, dtype)[0][0]

    def release(self) -> None:
        self._render = None

    # -- the loop --------------------------------------------------------
    def keys(self):
        return range(len(self.states))

    def warm(self) -> None:
        for k in self.keys():
            self._render(k)

    def step(self, i: int):
        k = int(self.order[i % len(self.order)])
        return k, self._render(k)

    @staticmethod
    def units(out) -> int:
        return 1

    @staticmethod
    def images(out):
        return [out]

    # -- the yardstick ---------------------------------------------------
    def reference(self, key: int, dtype: torch.dtype = torch.float32):
        """[(image, stats)] of pose ``key`` by the plain reference."""
        light = (frame_light(self.direction) if self.direction is not None
                 else None)
        return [render_view(*reference_arrays(self.states[key], self.device),
                            self.camera, light=light, dtype=dtype)]

    def bounds(self, stats: list) -> dict:
        """Bound seconds of one frame by kernel group, from its stats."""
        (st,) = stats
        n_attrs = 6 if self.direction is not None else 3
        h = w = self.size
        tri, pairs = st["triangles"], st["pairs"]
        return {"f1": bounds.f1(tri, 1, n_attrs, posed=False),
                "binning": bounds.binning(tri, 1, pairs, h, w),
                "raster": bounds.raster(tri, 1, pairs, st["window_pixels"],
                                        n_attrs, h, w)}
