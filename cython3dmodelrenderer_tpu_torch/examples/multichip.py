"""View and triangle sharding over spawned ranks, checked against the
unsharded render.

    python -m cython3dmodelrenderer_tpu_torch.examples.multichip \
        [--ranks 4] [--device cpu]

Counterpart of the repository's ``examples/multichip.py`` and of the JAX
dry run ``__graft_entry__.py::_dryrun_multichip_impl``, here also the
proof that sharding changes no bit. ``main`` spawns ``n_ranks``
processes; each initializes the default process group through a file in a
temporary directory, with gloo on the CPU and, on CUDA, NCCL when every
rank has a card of its own, else gloo (NCCL refuses two ranks on one
device; gloo's collectives take CUDA tensors). On a ``views x tris`` mesh
(tris 2 when the rank count is even) every rank renders, on the ratio
backend and on the kernel backend (``"cuda"`` on the card, their plain
versions on the CPU):

* the view-sharded turntable over ``views``: the views gathered over the
  axis must equal the unsharded sweep bit for bit;
* the triangle-sharded frame over ``tris``: its z must equal the
  unsharded frame's bit for bit.

A rank that fails raises, and ``main`` re-raises it.
"""
import argparse
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..config import RenderConfig
from ..device import resolve_backend, resolve_device
from ..ops import raster
from ..parallel import multiview
from ..parallel.mesh import make_mesh

CONFIG = RenderConfig(height=64, width=64, fov=45)


def tiny_scene(t: int, device):
    """``__graft_entry__._tiny_scene``: t random triangles around the
    origin, as (verts, normals, colours) float32 tensors."""
    rng = np.random.RandomState(0)
    centers = rng.uniform(-0.3, 0.3, size=(t, 1, 3)).astype(np.float32)
    centers[..., 2] = 0.0
    tris = centers + rng.uniform(-0.2, 0.2, size=(t, 3, 3)).astype(np.float32)
    normals = rng.randn(t, 3, 3).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    colors = rng.uniform(0, 255, size=(t, 3, 3)).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (tris, normals, colors)]


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def _require_bits(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    if got.shape != want.shape or not torch.equal(_bits(got), _bits(want)):
        raise AssertionError(f"{what}: sharded != unsharded")


def check_mesh(mesh, device: torch.device, kernel: str) -> list:
    """Both sharded modes on ``mesh`` against the unsharded render; returns
    a line for each check."""
    n_views = mesh.size(0) * 2
    tv, tn, tc = tiny_scene(16 * mesh.size(1), device)
    angles = multiview.turntable_angles(n_views)
    views_group = mesh.get_group("views")
    lines = []
    for backend, vb in (("ratio", 1), (kernel, 2)):
        mine = multiview.render_turntable_sharded(
            tv, tn, tc, angles, CONFIG, mesh, axis="views", bbox_size=32,
            chunk=16, backend=backend, view_batch=vb)
        parts = [torch.empty_like(mine) for _ in range(mesh.size(0))]
        dist.all_gather(parts, mine.contiguous(), group=views_group)
        if backend == "ratio":
            want = multiview.render_turntable(tv, tn, tc, angles, CONFIG,
                                              bbox_size=32, chunk=16)
        else:
            want = multiview.render_turntable_pallas(tv, tn, tc, angles,
                                                     CONFIG, backend=backend)
        _require_bits(torch.cat(parts), want, f"{backend} view-sharded turntable")
        lines.append(f"{backend}: {n_views} views sharded over views={mesh.size(0)}"
                     f" (view_batch {vb}) == the unsharded sweep")

    tv2 = tv + torch.tensor([0.0, 0.0, 1.0], device=device)
    for backend in ("ratio", kernel):
        color, z, _normal = multiview.render_triangle_sharded(
            tv2, tn, tc, CONFIG, mesh, axis="tris", bbox_size=32, chunk=16,
            backend=backend)
        if backend == "ratio":
            want = multiview.render_view(tv2, tn, tc, CONFIG, bbox_size=32,
                                         chunk=16)[1]
        else:
            want = raster.render_frame(tv2, tn, tc, CONFIG, post="none",
                                       backend=backend)[0][1]
        _require_bits(z, want, f"{backend} triangle-sharded z")
        covered = float((z < CONFIG.z_init).float().mean())
        lines.append(f"{backend}: {tv2.shape[0]} triangles sharded over "
                     f"tris={mesh.size(1)}, z == the unsharded frame's, "
                     f"{covered:.1%} of pixels covered")
    return lines


def _rank(rank: int, n_ranks: int, device_type: str, backend: str,
          init_file: str) -> None:
    if device_type == "cpu":   # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n_ranks))
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=n_ranks)
    try:
        tris_ax = 2 if n_ranks % 2 == 0 else 1
        mesh = make_mesh([("views", n_ranks // tris_ax), ("tris", tris_ax)],
                         device=device_type)
        device = resolve_device("cuda" if device_type == "cuda" else "cpu")
        lines = check_mesh(mesh, device, resolve_backend("auto", device))
        if rank == 0:
            print(f"multichip: {n_ranks} ranks ({backend}) on {device}, mesh "
                  f"views={mesh.size(0)} x tris={mesh.size(1)}", flush=True)
            for line in lines:
                print(f"  {line}", flush=True)
    finally:
        dist.destroy_process_group()


def main(n_ranks: int = 4, device=None) -> None:
    """Spawn ``n_ranks`` ranks and run ``check_mesh`` on each; ``device``
    as ``resolve_device`` (the card unless ``"cpu"``)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        backend = "gloo"
    else:
        backend = "nccl" if n_ranks <= torch.cuda.device_count() else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank, args=(n_ranks, dev.type, backend,
                              os.path.join(tmp, "pg")),
                 nprocs=n_ranks, join=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default=None)
    a = ap.parse_args()
    main(a.ranks, a.device)
