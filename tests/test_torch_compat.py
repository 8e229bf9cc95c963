"""The port's ``crender`` compat namespace and ``utils.timing``.

``tests/test_crender_compat.py``'s py and cy usages (transcriptions of the
reference's ``run.py``) and ``tests/test_utils.py``'s timing cases, on the
port with ``device="cpu"``. The mesh is ``assets/igor_sphere.obj``
(T-Rex is absent); it is untextured, so its colours come from each
Renderer's generator, which is seeded alike on both paths.
"""
import glob
import json
import os

import numpy as np
import pytest
import torch

from test_torch_raster import REPO

import cython3dmodelrenderer_tpu_torch as pt
from cython3dmodelrenderer_tpu_torch import crender
from cython3dmodelrenderer_tpu_torch.ops.illumination import cast_u8
from cython3dmodelrenderer_tpu_torch.utils import timing

SPHERE = os.path.join(REPO, "assets", "igor_sphere.obj")
SIZE = 128
PORT_NAMES = {
    "data_structures": ("Buffer", "Model"),
    "illumination": ("IlluminationDrawer", "NoIllumination", "GuroIllumination"),
    "pixel_buffer_filler": ("PixelBufferFiller", "AdvancedPixelBufferFiller",
                            "EdgeOnlyPixelBufferFiller"),
    "triangle_iterator": ("TriangleIterator", "SimpleIterator", "DepthIterator"),
}


def posed_model(model_cls):
    """The reference ``run.py:28-33`` pose, then one more unit of depth, as
    ``bench.py`` poses the unit spheres (the fitted sphere would hold the
    camera)."""
    model = model_cls.read_model(SPHERE, device="cpu")
    model.rotate([-90, 180, 0])
    model.rotate([10, -80, 0])
    model.shift(-model.get_mean_vertex())
    model.scale(1 / model.get_max_span())
    model.shift(shift=[0, 0, 1])       # keyword form, as the reference run.py:33
    model.shift([0, 0, 1])
    return model


def py_usage():
    """The reference's py_renderer (``run.py:11-17``)."""
    import cython3dmodelrenderer_tpu_torch.crender.py as py
    from cython3dmodelrenderer_tpu_torch.crender.py.data_structures import Model
    from cython3dmodelrenderer_tpu_torch.crender.py.triangle_iterator import \
        SimpleIterator

    model = posed_model(Model)
    filler = py.pixel_buffer_filler.AdvancedPixelBufferFiller(
        SIZE, SIZE, fov=45, device="cpu")
    illumination = py.illumination.GuroIllumination([0, 0, 1])
    renderer = py.Renderer(filler, illumination, SimpleIterator,
                           *filler.get_size(), use_tqdm=False,
                           generator=torch.Generator().manual_seed(4))
    return renderer.render(model)


def cy_usage():
    """The reference's cy_renderer (``run.py:20-26``)."""
    from cython3dmodelrenderer_tpu_torch.crender.cy import Renderer
    from cython3dmodelrenderer_tpu_torch.crender.cy.data_structures import Model
    from cython3dmodelrenderer_tpu_torch.crender.cy.illumination import \
        GuroIllumination
    from cython3dmodelrenderer_tpu_torch.crender.cy.pixel_buffer_filler import \
        AdvancedPixelBufferFiller
    from cython3dmodelrenderer_tpu_torch.crender.cy.triangle_iterator import \
        SimpleIterator

    model = posed_model(Model)
    filler = AdvancedPixelBufferFiller(SIZE, SIZE, fov=45, device="cpu")
    illumination = GuroIllumination([0, 0, 1])
    renderer = Renderer(filler, illumination, SimpleIterator,
                        *filler.get_size(), use_tqdm=False,
                        generator=torch.Generator().manual_seed(4))
    return renderer.render(model), filler


def test_reference_py_usage():
    image = py_usage()
    arr = image.get_image()
    assert arr.dtype == np.uint8 and arr.shape == (SIZE, SIZE, 3)
    assert (arr.sum(-1) > 0).mean() > 0.1


def test_reference_cy_usage(tmp_path):
    """The cy contract: a host float32 array, which the caller flips and
    casts; it is the filler's G-buffers shaded, and cast to uint8 it is the
    py Renderer's image (the kernel order of the Lambert u8 post)."""
    image, filler = cy_usage()
    assert isinstance(image, np.ndarray) and image.dtype == np.float32
    assert image.shape == (SIZE, SIZE, 3)
    shaded = pt.GuroIllumination([0, 0, 1]).apply(filler.get_color_buffer(),
                                                   filler.get_normals_buffer())
    np.testing.assert_array_equal(image.view(np.int32),
                                  shaded.numpy().view(np.int32))
    np.testing.assert_array_equal(cast_u8(torch.from_numpy(image)).numpy(),
                                  py_usage().get_image())
    out = image[::-1].astype("uint8")
    assert out.max() > 0

    import cv2

    assert cv2.imwrite(str(tmp_path / "compat.png"), out)


def test_namespace_resolves_to_the_port():
    assert crender.Renderer is pt.Renderer is crender.py.Renderer
    assert issubclass(crender.cy.Renderer, pt.Renderer)
    for tree in (crender.py, crender.cy):
        for module, names in PORT_NAMES.items():
            mod = getattr(tree, module)
            assert tuple(mod.__all__) == names
            for name in names:
                assert getattr(mod, name) is getattr(pt, name)


def test_namespace_defaults_to_the_card():
    """No device means the card, as everywhere in the port."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        crender.cy.pixel_buffer_filler.AdvancedPixelBufferFiller(SIZE, SIZE)
    with pytest.raises(RuntimeError, match="CUDA"):
        crender.py.data_structures.Model.read_model(SPHERE)


def test_frame_stats():
    stats = timing.FrameStats(ms_per_frame=2.0, frames=10, triangles=10000,
                              pairs=12000, active_tiles=64)
    assert stats.mtris_per_sec == pytest.approx(5.0)


def test_time_frames_calls_and_fences():
    calls = []

    def fn():
        calls.append(1)
        return (torch.ones(8, 8) * 2, [pt.Buffer(4, 4, device="cpu")])

    ms = timing.time_frames(fn, n_warm=1, n_iter=3)
    assert ms > 0 and len(calls) == 4
    assert timing._cuda_devices(fn()) == set()


def test_profile_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    with timing.profile_trace(log_dir) as d:
        assert d == log_dir
        (torch.zeros(64, 64) + 1).sum()
    files = glob.glob(os.path.join(log_dir, "*.json"))
    assert files
    with open(files[0]) as f:
        assert json.load(f)["traceEvents"]
