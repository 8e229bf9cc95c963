"""The port imports torch and numpy only: no jax, no cv2, no tqdm, and no
CUDA initialisation on the CPU path."""
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
from cython3dmodelrenderer_tpu_torch.ops import (binning, binsort, illumination,
                                                 projection, raster, raster_ref,
                                                 sort, transforms)
after_import = sorted(m for m in WATCH if m in set(sys.modules) - baseline)
# the main path on the CPU, including a mesh whose texture file is missing
model = pt.Model.read_model(sys.argv[1])
model.rotate([10, -80, 0])
pt.fit_model(model)
model.shift([0.0, 0.0, 1.0])
r = pt.Renderer(pt.AdvancedPixelBufferFiller(32, 32, fov=45),
                pt.GuroIllumination([0, 0, 1]), pt.SimpleIterator, 32, 32)
img = r.render(model).get_image()
z = r.z_buffer.get_image()
print(json.dumps({
    "after_import": after_import,
    "after_render": sorted(m for m in WATCH if m in set(sys.modules) - baseline),
    "cuda_initialized": torch.cuda.is_initialized(),
    "lit": int((img.max(-1) > 0).sum()), "z_min": float(z.min()),
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


def test_cuda_backend_needs_a_cuda_device():
    import pytest
    import torch

    from cython3dmodelrenderer_tpu_torch import AdvancedPixelBufferFiller
    from cython3dmodelrenderer_tpu_torch.device import resolve_device

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(ValueError, match="CUDA device"):
        AdvancedPixelBufferFiller(8, 8, backend="cuda")
    assert AdvancedPixelBufferFiller(8, 8).backend == "torch"
