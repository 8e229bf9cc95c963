"""Closed-loop single frames of an untextured model through
``Renderer.render``.

The loop, sizes, poses, jitter and order of ``frames.py`` at the same
seed, but the posed copies carry no colours: ``Renderer.render`` draws
fallback colours (``random_colors=True``), one random colour a triangle,
on every frame.

So that ``correct`` stays decidable, the step reseeds the renderer's
documented CPU ``torch.Generator`` (``Renderer.generator``) before each
frame with a seed drawn from ``--seed`` for the frame's pose. The
reference then follows the port's documented generator rule
(``renderer.py``, ``Renderer._fallback_colors``): ``torch.randint(256,
(T, 3), generator=...)``, cast to float32, one colour for the three
vertices of each triangle. It imports nothing of the program: it hands
``render.render_view`` the triangle soup (vertices, normals and colours
gathered by face, faces ``arange(3T)``). A change that draws the
colours elsewhere has to keep that stream equal, or come with a change
to this reference.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

import harness
from reference.render import frame_light, render_view
from scene import program_renderer

frames = harness.load_module(Path(__file__).with_name("frames.py"))


class Driver(frames.Driver):
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        super().__init__(config, traffic, seed, device)
        for s in self.states:
            del s["colors"], s["faces_vt"]
        self.color_seeds = [int(x) for x in np.random.default_rng(
            [seed, 1]).integers(0, 2 ** 63, len(self.states))]

    def build_program(self) -> None:
        program, renderer = program_renderer(self.camera, self.size,
                                             self.direction, self.device)
        models = [program.Model.from_state(s, device=self.device)
                  for s in self.states]

        def render(k):
            renderer.generator.manual_seed(self.color_seeds[k])
            return renderer.render(models[k], random_colors=True).array
        self._render = render

    def soup(self, key: int) -> list:
        """(vertices, faces, normals, colors) of pose ``key`` as a triangle
        soup on the device, coloured by the renderer's generator rule."""
        s = self.states[key]
        t = len(s["faces_v"])
        generator = torch.Generator().manual_seed(self.color_seeds[key])
        per_tri = torch.randint(256, (t, 3), generator=generator)
        return [torch.from_numpy(np.ascontiguousarray(
                    s["vertices"][s["faces_v"]].reshape(-1, 3))).to(self.device),
                torch.arange(3 * t, device=self.device).reshape(t, 3),
                torch.from_numpy(np.ascontiguousarray(
                    s["normals"][s["faces_n"]].reshape(-1, 3))).to(self.device),
                per_tri.to(torch.float32).repeat_interleave(3, dim=0)
                .to(self.device)]

    def reference(self, key: int, dtype: torch.dtype = torch.float32):
        light = (frame_light(self.direction) if self.direction is not None
                 else None)
        return [render_view(*self.soup(key), self.camera, light=light,
                            dtype=dtype)]
