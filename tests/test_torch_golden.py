"""The port against the committed golden render ``assets/golden_sphere.png``
and on an empty OBJ (``tests/test_edge_cases.py::test_empty_obj_model``).

``tools/make_golden.py`` rendered the golden with the JAX package's
ratio-form oracle (``backend="jnp"``, default XLA flags) at 512², fov 45:
igor_sphere posed as in the README, ``RandomState(0)`` per-triangle
colours, Guro light [0, 0, 1]. The port builds the same scene itself and
renders it with ``backend="ratio"`` and with the plain kernel backend
(``"torch"``). Neither is bit-equal to the PNG — the port's transforms sit
within 1e-6 of JAX's (``test_torch_scene.py``) and the golden's XLA
program contracted multiply-adds into FMAs — so both are held to
``test_golden_standalone``'s bounds (``tests/test_renderer.py:298-325``),
and the differing-pixel counts stay small (PERF.md records them).
"""
import os

import numpy as np
import pytest
import torch

from test_torch_raster import REPO

import cython3dmodelrenderer_tpu_torch as pt

GOLDEN = os.path.join(REPO, "assets", "golden_sphere.png")
SIZE = 512


def golden_scene():
    """``tools/make_golden.py::build_scene`` on the port."""
    model = pt.Model.read_model(os.path.join(REPO, "assets", "igor_sphere.obj"),
                                external_texture_filename=None, device="cpu")
    model.rotate([-90, 180, 0])
    model.rotate([10, -80, 0])
    pt.fit_model(model)
    model.shift([0.0, 0.0, 1.0])
    per_tri = np.random.RandomState(0).randint(256, size=(model.n_triangles(), 3))
    colors = np.repeat(per_tri[:, None, :], 3, axis=1).astype(np.float32)
    return model, torch.from_numpy(colors)


@pytest.mark.parametrize("backend,max_differing", [("ratio", 60),
                                                   ("torch", 150)])
def test_golden_sphere(backend, max_differing):
    import cv2

    golden = cv2.imread(GOLDEN)
    assert golden is not None, "assets/golden_sphere.png missing"
    golden = golden[::-1]                        # file rows are flipped on write
    model, colors = golden_scene()
    filler = pt.AdvancedPixelBufferFiller(SIZE, SIZE, fov=45, backend=backend,
                                          device="cpu")
    filler.render_model(model, colors_override=colors, post="lambert_u8",
                        light=pt.GuroIllumination([0, 0, 1]).light_direction)
    ours = filler.get_post_image().numpy()
    assert ours.shape == golden.shape
    differing = int((ours != golden).any(-1).sum())
    print(f"{backend}: {differing} of {SIZE * SIZE} pixels differ from "
          "the golden")
    if differing:
        ours_mask = ours.sum(-1) > 15
        gold_mask = golden.sum(-1) > 15
        iou = (ours_mask & gold_mask).sum() / (ours_mask | gold_mask).sum()
        assert iou > 0.998, f"silhouette IoU too low: {iou}"
        both = ours_mask & gold_mask
        mae = np.abs(ours[both].astype(np.float32)
                     - golden[both].astype(np.float32)).mean()
        assert mae < 0.5, f"color MAE too high: {mae}"
        frac_big = (np.abs(ours.astype(np.float32)
                           - golden.astype(np.float32)).max(-1) > 20).mean()
        assert frac_big < 0.002, f"too many >20-diff pixels: {frac_big}"
    assert differing <= max_differing, differing


@pytest.mark.parametrize("backend", ["ratio", "torch"])
def test_empty_obj_renders_background(tmp_path, backend):
    path = tmp_path / "empty.obj"
    path.write_text("# nothing but a vertex\nv 0 0 0\n")
    model = pt.Model.read_model(str(path), device="cpu")
    assert model.n_triangles() == 0
    renderer = pt.Renderer(pt.AdvancedPixelBufferFiller(32, 32, backend=backend,
                                                        device="cpu"),
                           pt.NoIllumination(), pt.SimpleIterator, 32, 32)
    assert renderer.render(model).get_image().max() == 0
    assert renderer.z_buffer.get_image().min() == np.float32(1e6)
