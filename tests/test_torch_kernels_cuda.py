"""Kernels B1 (raster) and B2 (sort) against their plain PyTorch versions.

These need a CUDA device (and nvcc to build ``csrc/``); without one the
``cuda`` fixture skips them. On the card every comparison is exact.
"""
import numpy as np
import pytest
import torch

from cython3dmodelrenderer_tpu_torch.config import RenderConfig
from cython3dmodelrenderer_tpu_torch.ops import binning, binsort, raster
from cython3dmodelrenderer_tpu_torch.ops.projection import (project_to_screen,
                                                            visibility_masks)
from cython3dmodelrenderer_tpu_torch.ops.sort import sort_i32, sort_i32_plain
from test_torch_raster import light_direction, random_scene


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernels B1/B2 have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("n", [1, 2, 1000, 24576, 1 << 15, (1 << 18) + 17])
def test_sort_kernel_matches_torch_sort(cuda, n):
    gen = torch.Generator(device=cuda).manual_seed(n)
    keys = (torch.randperm(4 * n, generator=gen, device=cuda)[:n] * 511
            + 3).to(torch.int32)
    before = sort_i32.launches
    got = sort_i32(keys)
    torch.cuda.synchronize()
    assert torch.equal(got, sort_i32_plain(keys))
    assert sort_i32.launches == before + 1


def binned(cuda, h, w, t, seed, n_attrs):
    tris, colors, normals = random_scene(t, seed)
    cfg = RenderConfig(height=h, width=w, fov=60)
    tv, tn, tc = (torch.from_numpy(a).to(cuda) for a in (tris, normals, colors))
    deg, back = visibility_masks(tv, tn)
    rows, tx0, cx, ty0, cy, counts = binning.plane_data(
        project_to_screen(tv, cfg), ~deg & ~back, cfg, 16, 32, colors=tc,
        normals=tn if n_attrs == 6 else None)
    ntx, nty = -(-w // 32), -(-h // 16)
    pair_tri, starts, tcounts = binsort.bin_pairs(tx0, cx, ty0, cy, ntx, nty,
                                                  int(counts.sum()))
    return dict(rows=rows, pair_tri=pair_tri, tile_starts=starts,
                tile_counts=tcounts, ntx=ntx, nty=nty, height=h, width=w,
                n_attrs=n_attrs, z_init=1e6)


@pytest.mark.parametrize("h,w,t", [(64, 64, 60), (70, 100, 200), (1024, 1024, 3000)])
@pytest.mark.parametrize("post", ["none", "u8", "lambert_u8"])
def test_raster_kernel_matches_plain(cuda, h, w, t, post):
    kw = binned(cuda, h, w, t, t, 3 if post == "u8" else 6)
    light = light_direction() if post == "lambert_u8" else None
    opts = dict(light=light, gbuffer=post == "none", image=post != "none")
    before = raster.raster_tiles.launches
    g_k, i_k = raster.raster_tiles(**kw, **opts)
    g_p, i_p = raster.raster_tiles_plain(**kw, **opts)
    torch.cuda.synchronize()
    assert raster.raster_tiles.launches == before + 1
    if post == "none":
        for a, b in zip(g_k, g_p):
            np.testing.assert_array_equal(a.cpu().numpy().view(np.int32),
                                          b.cpu().numpy().view(np.int32))
    else:
        assert torch.equal(i_k, i_p)


def test_frame_backends_agree(cuda):
    tris, colors, normals = random_scene(400, 11)
    cfg = RenderConfig(height=256, width=192, fov=50)
    args = [torch.from_numpy(a).to(cuda) for a in (tris, normals, colors)]
    for post in ("none", "u8", "lambert_u8"):
        k = raster.render_frame(*args, cfg, post=post, light=light_direction(),
                                backend="cuda")
        p = raster.render_frame(*args, cfg, post=post, light=light_direction(),
                                backend="torch")
        assert k[2] == p[2]
        if post == "none":
            assert all(torch.equal(a, b) for a, b in zip(k[0], p[0]))
        else:
            assert torch.equal(k[1], p[1])
