"""The port imports torch and numpy only: no jax, no cv2, no tqdm, and no
CUDA initialisation on the CPU path (the batched frame, the ratio backend,
the wireframe), which a caller takes by asking for ``device="cpu"``; with
no device the entry points need the card."""
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import json, sys
import torch
baseline = set(sys.modules)          # torch may pull in tqdm itself
WATCH = ("jax", "cv2", "tqdm", "cython3dmodelrenderer_tpu")
import cython3dmodelrenderer_tpu_torch as pt
from cython3dmodelrenderer_tpu_torch import measure
from cython3dmodelrenderer_tpu_torch.ops import (binning, binsort,
                                                 binsort_grouped, illumination,
                                                 projection, raster, raster_ref,
                                                 sort, transforms, wireframe)
from cython3dmodelrenderer_tpu_torch.parallel import multiview
from cython3dmodelrenderer_tpu_torch.probes import epi_prims, vpu_cal
from cython3dmodelrenderer_tpu_torch.utils import oracle
after_import = sorted(m for m in WATCH if m in set(sys.modules) - baseline)
# the main path on the CPU, including a mesh whose texture file is missing
model = pt.Model.read_model(sys.argv[1], device="cpu")
model.rotate([10, -80, 0])
pt.fit_model(model)
model.shift([0.0, 0.0, 1.0])
r = pt.Renderer(pt.AdvancedPixelBufferFiller(32, 32, fov=45, device="cpu"),
                pt.GuroIllumination([0, 0, 1]), pt.SimpleIterator, 32, 32)
img = r.render(model).get_image()
z = r.z_buffer.get_image()
# the ratio backend and the wireframe
r = pt.Renderer(pt.AdvancedPixelBufferFiller(32, 32, fov=45, backend="ratio",
                                             device="cpu"),
                pt.GuroIllumination([0, 0, 1]), pt.SimpleIterator, 32, 32)
lit_ratio = int((r.render(model).get_image().max(-1) > 0).sum())
w = pt.Renderer(pt.EdgeOnlyPixelBufferFiller(pt.LineBresenham(), [255] * 3),
                pt.NoIllumination(), pt.SimpleIterator, 32, 32, device="cpu")
lit_wire = int((w.render(model, normalize_model=True).get_image() > 0).sum())
print(json.dumps({
    "after_import": after_import,
    "after_render": sorted(m for m in WATCH if m in set(sys.modules) - baseline),
    "cuda_initialized": torch.cuda.is_initialized(),
    "lit": int((img.max(-1) > 0).sum()), "z_min": float(z.min()),
    "lit_ratio": lit_ratio, "lit_wire": lit_wire,
}))
"""


def test_port_imports_no_jax_and_stays_on_cpu(igor_sphere_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", PROBE, igor_sphere_path],
                         env=env, cwd=REPO, capture_output=True, text=True,
                         timeout=300, check=False)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["after_import"] == []
    assert out["after_render"] == []          # missing texture: no cv2 either
    assert out["cuda_initialized"] is False
    assert out["lit"] > 0 and out["z_min"] < 1.0
    assert out["lit_ratio"] > 0 and out["lit_wire"] > 0


def test_no_jax_import_in_the_package_sources():
    root = os.path.join(REPO, "cython3dmodelrenderer_tpu_torch")
    offenders = []
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                with open(path) as f:
                    for lineno, line in enumerate(f, 1):
                        s = line.strip()
                        if s.startswith(("import jax", "from jax",
                                         "import cython3dmodelrenderer_tpu ",
                                         "from cython3dmodelrenderer_tpu ",
                                         "from cython3dmodelrenderer_tpu.")):
                            offenders.append(f"{path}:{lineno}")
    assert offenders == []


def test_cuda_backend_needs_a_cuda_device(igor_sphere_path, tmp_path):
    """The entry points run on the card unless asked for the CPU: without
    CUDA, each one given no device raises (no fallback), and
    ``device="cpu"`` is the way onto the CPU."""
    import numpy as np
    import pytest
    import torch

    import cython3dmodelrenderer_tpu_torch as pt
    from cython3dmodelrenderer_tpu_torch.device import resolve_device
    from cython3dmodelrenderer_tpu_torch.ops.transforms import rotation_matrix

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device(device)
    with pytest.raises(ValueError, match="CUDA device"):
        pt.AdvancedPixelBufferFiller(8, 8, backend="cuda", device="cpu")
    cpu_buf = pt.Buffer(2, 2, device="cpu")
    cpu_buf.save(str(tmp_path / "b.npz"))
    no_device = [
        lambda: pt.AdvancedPixelBufferFiller(8, 8),
        lambda: pt.Renderer(pt.PixelBufferFiller(), pt.NoIllumination(),
                            pt.SimpleIterator, 8, 8),
        lambda: pt.Renderer(pt.EdgeOnlyPixelBufferFiller(pt.LineBresenham(),
                                                         [255] * 3),
                            pt.NoIllumination(), pt.SimpleIterator, 8, 8),
        lambda: pt.AdvancedPixelBufferFiller(8, 8, backend="ratio"),
        lambda: pt.Model.read_model(igor_sphere_path),
        lambda: pt.Model(np.eye(3, dtype=np.float32), [[0, 1, 2]]),
        lambda: pt.Model.from_state({
            "vertices": np.eye(3, dtype=np.float32), "faces_v": [[0, 1, 2]],
            "normals": np.eye(3, dtype=np.float32), "faces_n": [[0, 1, 2]]}),
        lambda: pt.Buffer(2, 2),
        lambda: pt.Buffer.load(str(tmp_path / "b.npz")),
        lambda: rotation_matrix([0.0, 90.0, 0.0]),
    ]
    for make in no_device:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    filler = pt.AdvancedPixelBufferFiller(8, 8, device="cpu")
    assert filler.backend == "torch" and filler.device.type == "cpu"
    renderer = pt.Renderer(filler, pt.NoIllumination(), pt.SimpleIterator, 8, 8)
    assert renderer.device.type == "cpu"            # the filler's device
    assert rotation_matrix([0.0, 90.0, 0.0], device="cpu").device.type == "cpu"
    assert not torch.cuda.is_initialized()
