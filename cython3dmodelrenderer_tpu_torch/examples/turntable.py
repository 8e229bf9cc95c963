"""A turntable sweep through ``render_turntable_pallas`` on the card.

    python -m cython3dmodelrenderer_tpu_torch.examples.turntable \
        [--views 64] [--size 1024] [--view-batch 1]

Counterpart of the repository's ``examples/turntable.py``. The model is
``$CRENDER_OBJECTS/T-Rex.obj`` where that file exists, else the in-repo
``assets/igor_sphere.obj`` (untextured: seeded flat colours; one unit
deeper, as ``bench.py`` poses the unit spheres); nothing is downloaded. Prints the time of one warm sweep (host clock, fenced on the
card) and ms a view, and writes every 8th view to
``output/turntable_NN.png`` with OpenCV, which is imported only to write.
"""
import argparse
import os

import torch

from ..config import RenderConfig
from ..device import resolve_backend, resolve_device
from ..models.model import Model
from ..parallel import multiview
from ..utils.timing import time_frames

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT = os.path.join(REPO, "output")


def load_model(device):
    """The centred, unit-span model in the README rotation, its (T, 3, 3)
    float32 colours and the shift the turntable applies to every view."""
    trex = os.path.join(os.environ.get("CRENDER_OBJECTS", ""), "T-Rex.obj")
    if os.environ.get("CRENDER_OBJECTS") and os.path.exists(trex):
        path, post_shift = trex, (0.0, 0.0, 1.0)
    else:
        path = os.path.join(REPO, "assets", "igor_sphere.obj")
        post_shift = (0.0, 0.0, 2.0)
    model = Model.read_model(path, device=device)
    model.rotate([-90, 180, 0])
    model.shift(-model.get_mean_vertex())
    model.scale(1.0 / model.get_max_span())
    colors = model.colors_by_triangles
    if colors is None:
        per_tri = torch.randint(256, (model.n_triangles(), 1, 3),
                                generator=torch.Generator().manual_seed(0))
        colors = per_tri.expand(-1, 3, 3).to(device=model.device,
                                             dtype=torch.float32)
    return model, colors.to(torch.float32).contiguous(), post_shift


def main(n_views: int = 64, size: int = 1024, view_batch: int = 1,
         device=None, write: bool = True):
    """Render the sweep; returns ((N, size, size, 3) float32 frames on the
    device, ms a view). ``device`` as ``resolve_device`` (the card unless
    ``"cpu"``); the kernels run on CUDA, their plain versions on the CPU."""
    dev = resolve_device(device)
    model, colors, post_shift = load_model(dev)
    tv, tn = model.vertices_by_triangles, model.normals_by_triangles
    config = RenderConfig(height=size, width=size, fov=45)
    angles = multiview.turntable_angles(n_views)
    backend = resolve_backend("auto", dev)

    def sweep():
        return multiview.render_turntable_pallas(
            tv, tn, colors, angles, config, post_shift=post_shift,
            view_batch=view_batch, backend=backend)

    frames = sweep()
    ms = time_frames(sweep, n_warm=0, n_iter=1)
    print(f"{n_views} views x {size}x{size} on {dev} ({backend}): "
          f"{ms:.1f} ms ({ms / n_views:.2f} ms/view)")
    if write:
        import cv2

        os.makedirs(OUT, exist_ok=True)
        host = frames[::8].cpu().numpy()
        for k, frame in enumerate(host):
            cv2.imwrite(os.path.join(OUT, f"turntable_{8 * k:02d}.png"),
                        frame[::-1].astype("uint8"))
        print(f"wrote {len(host)} frames to {OUT}/turntable_*.png")
    return frames, ms / n_views


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--views", type=int, default=64)
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--view-batch", type=int, default=1)
    a = ap.parse_args()
    main(a.views, a.size, a.view_batch)
