"""Closed-loop turntables through ``Renderer.render_sequence``.

One user renders sweep after sweep of the centred README pose. The
traffic file gives the image ``size``, the ``views`` of a sweep, the
``view_batch`` and the number of seeded ``phases``; the configuration's
``pose["shift"]`` places each turned view. Sweep p turns about y by
``360 i / views`` degrees plus phase p (a seeded angle under one view's
step); the loop takes the phases in turn. A step is one sweep; its key
is its phase.
"""
from __future__ import annotations

import numpy as np
import torch

from reference import bounds, meshes
from reference.render import render_view, sweep_light
from scene import program_renderer, reference_arrays


class Driver:
    unit = "view"

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        rng = np.random.default_rng(seed)
        self.views = self.images_per_key = int(traffic["views"])
        self.view_batch = int(traffic["view_batch"])
        if self.views % self.view_batch:
            raise ValueError("view_batch must divide views")
        step = np.float32(360.0) / np.float32(self.views)
        phases = rng.uniform(0.0, float(step), int(traffic["phases"]))
        deg = np.float32(360.0) * (np.arange(self.views, dtype=np.float32)
                                   / np.float32(self.views))
        zeros = np.zeros_like(deg)
        self.angles = [np.stack([zeros, deg + np.float32(p), zeros], axis=1)
                       for p in phases]
        self.shifts = np.broadcast_to(np.float32(config["pose"]["shift"]),
                                      (self.views, 3)).copy()
        vertices, faces = meshes.build(config["mesh"])
        colors = meshes.seeded_colors(len(vertices), rng)
        self.state = meshes.centred_state(vertices, faces, config["pose"],
                                          colors)
        self.device = torch.device(device)
        self.size = int(traffic["size"])
        self.camera = dict(config["camera"], width=self.size, height=self.size)
        self.direction = config.get("light")
        batches = self.views // self.view_batch
        #: device kernels a step launches: one F1 and one B1 a view batch
        self.kernels_per_step = {"frontend_kernel": batches,
                                 "raster_kernel": batches}
        self._render = None

    # -- the system under test ----------------------------------------
    def build_program(self) -> None:
        program, renderer = program_renderer(self.camera, self.size,
                                             self.direction, self.device)
        model = program.Model.from_state(self.state, device=self.device)
        self._render = lambda p: renderer.render_sequence(
            model, self.angles[p], self.shifts, view_batch=self.view_batch)

    def build_control(self, dtype: torch.dtype) -> None:
        """The reference in the program's place, computed in ``dtype``."""
        self._render = lambda p: torch.stack(
            [img for img, _st in self.reference(p, dtype)])

    def release(self) -> None:
        self._render = None

    # -- the loop --------------------------------------------------------
    def keys(self):
        return range(len(self.angles))

    def warm(self) -> None:
        for p in self.keys():
            self._render(p)

    def step(self, i: int):
        p = i % len(self.angles)
        return p, self._render(p)

    @staticmethod
    def units(out) -> int:
        return int(out.shape[0])

    def images(self, out):
        return [out[v] if v < len(out) else None for v in range(self.views)]

    # -- the yardstick ---------------------------------------------------
    def reference(self, key: int, dtype: torch.dtype = torch.float32):
        """[(image, stats)] of each view of phase ``key``."""
        arrays = reference_arrays(self.state, self.device)
        light = (sweep_light(self.direction) if self.direction is not None
                 else None)
        return [render_view(*arrays, self.camera, light=light,
                            pose=(self.angles[key][v], self.shifts[v]),
                            dtype=dtype)
                for v in range(self.views)]

    def bounds(self, stats: list) -> dict:
        """Bound seconds of one sweep by kernel group: each view batch's
        F1, binning and B1, from the views' stats."""
        n_attrs = 3 if self.direction is None else 6
        h = w = self.size
        vb = self.view_batch
        out = {"f1": 0.0, "binning": 0.0, "raster": 0.0}
        for b in range(0, self.views, vb):
            batch = stats[b:b + vb]
            tri = batch[0]["triangles"]
            pairs = sum(s["pairs"] for s in batch)
            area = sum(s["window_pixels"] for s in batch)
            out["f1"] += bounds.f1(tri, vb, n_attrs, posed=True)
            out["binning"] += bounds.binning(tri, vb, pairs, h, w)
            out["raster"] += bounds.raster(tri, vb, pairs, area, n_attrs, h, w)
        return out
