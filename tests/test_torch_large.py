"""The un-grouped path — counting-sort bins (B4) + raster (B1) — against JAX.

JAX side: ``raster_pallas.render_frame(..., group=1, interpret=True)``
(``binning.bin_pairs`` + the one-tile-per-step Pallas kernel B3 in
interpret mode, image derived from the G-buffers in XLA),
``raster_pallas.rasterize(..., interpret=True)``, and two ``group=16``
frames past ``grouped_limits_ok`` that the JAX package degrades to that
path (an image 64 tiles wide; 2^17 + 64 triangles, after
``tests/test_raster_pallas.py::test_grouped_degrades_past_packing_limits``).
It runs in a subprocess with FMA contraction off (see
``test_torch_raster.py``), so the port must agree bit for bit. Every port
frame here must take the counting-sort route: the sort route's entry
point is replaced by one that fails.
"""
import os
import sys

import numpy as np
import pytest
import torch

from test_torch_raster import (REPO, bits, light_direction, random_scene,
                               run_jax_reference, scenes)

PAD_TRIS = (1 << 17) + 64


def padded_scene():
    """24 live triangles padded with culled zero-area ones past 2^17."""
    tris, colors, normals = random_scene(24, 11)
    pad = PAD_TRIS - len(tris)
    return (np.concatenate([tris, np.zeros((pad, 3, 3), np.float32)
                            + [0.0, 0.0, 1.0]]),
            np.concatenate([colors, np.zeros((pad, 3, 3), np.float32)]),
            np.concatenate([normals, np.tile(np.float32([0, 0, -1]),
                                             (pad, 3, 1))]))


def frames():
    """(name, h, w, fov, tris, colors, normals, lean, group, rasterize)."""
    out = [(name, h, w, fov, tris, colors, normals, lean, 1,
            name == "odd70x100")
           for name, h, w, fov, tris, colors, normals, lean in scenes()]
    out.append(("wide32x2048", 32, 2048, 60.0, *random_scene(60, 7), False,
                16, False))
    out.append(("pad64", 64, 64, 60.0, *padded_scene(), False, 16, False))
    return out


@pytest.fixture(scope="module")
def jax_frames(tmp_path_factory):
    job = {"light": light_direction()}
    for name, h, w, fov, tris, colors, normals, lean, group, ras in frames():
        job[f"{name}/hwf"] = np.array([h, w, fov], np.float32)
        job[f"{name}/tris"], job[f"{name}/colors"] = tris, colors
        job[f"{name}/normals"] = normals
        job[f"{name}/flags"] = np.array([lean, group, ras], np.int32)
    return run_jax_reference(os.path.abspath(__file__), job,
                             tmp_path_factory.mktemp("jax_large"))


@pytest.fixture
def counting_route_only(monkeypatch):
    from cython3dmodelrenderer_tpu_torch.ops import raster

    def sort_route(*_args, **_kwargs):
        raise AssertionError("frame took the sort route")

    monkeypatch.setattr(raster, "bin_pairs", sort_route)


def port_frame(frame, post):
    from cython3dmodelrenderer_tpu_torch.config import RenderConfig
    from cython3dmodelrenderer_tpu_torch.ops.raster import render_frame

    _name, h, w, fov, tris, colors, normals, _lean, group, _ras = frame
    return render_frame(torch.from_numpy(tris), torch.from_numpy(normals),
                        torch.from_numpy(colors),
                        RenderConfig(height=h, width=w, fov=fov), post=post,
                        light=light_direction(), group=group)


def assert_gbuffer_equal(gbuf, jax_frames, prefix):
    for got, key in zip(gbuf, ("color", "z", "normal")):
        np.testing.assert_array_equal(bits(got.numpy()),
                                      bits(jax_frames[f"{prefix}{key}"]))


@pytest.mark.parametrize("frame", frames(), ids=lambda f: f[0])
def test_ungrouped_gbuffer_and_lambert_bit_equal(jax_frames, frame,
                                                 counting_route_only):
    name = frame[0]
    gbuf, img, n_pairs = port_frame(frame, "none")
    assert img is None and n_pairs > 0
    assert_gbuffer_equal(gbuf, jax_frames, f"{name}/")
    assert (gbuf[1].numpy() < 1.0).mean() > 0.05
    _g, img, _n = port_frame(frame, "lambert_u8")
    np.testing.assert_array_equal(img.numpy(), jax_frames[f"{name}/lambert"])
    assert img.numpy().max() > 0


@pytest.mark.parametrize("frame", [f for f in frames() if f[7]],
                         ids=lambda f: f[0])
def test_ungrouped_u8_bit_equal(jax_frames, frame, counting_route_only):
    _g, img, _n = port_frame(frame, "u8")
    np.testing.assert_array_equal(img.numpy(), jax_frames[f"{frame[0]}/u8"])


@pytest.mark.parametrize("frame", [f for f in frames() if f[9]],
                         ids=lambda f: f[0])
def test_rasterize_bit_equal(jax_frames, frame, counting_route_only):
    from cython3dmodelrenderer_tpu_torch.config import RenderConfig
    from cython3dmodelrenderer_tpu_torch.ops.projection import (
        project_to_screen, visibility_masks)
    from cython3dmodelrenderer_tpu_torch.ops.raster import rasterize

    name, h, w, fov, tris, colors, normals, *_rest = frame
    config = RenderConfig(height=h, width=w, fov=fov)
    tv, tn, tc = (torch.from_numpy(a) for a in (tris, normals, colors))
    deg, back = visibility_masks(tv, tn)
    gbuf = rasterize(project_to_screen(tv, config), tc, tn, ~deg & ~back,
                     config)
    assert_gbuffer_equal(gbuf, jax_frames, f"{name}/rasterize/")
    empty = rasterize(torch.zeros((0, 3, 3)), torch.zeros((0, 3, 3)),
                      torch.zeros((0, 3, 3)), torch.zeros(0, dtype=torch.bool),
                      config)
    assert float(empty[1].min()) == 1e6 and float(empty[0].abs().max()) == 0


def test_filler_routes_as_the_jax_filler(jax_frames, counting_route_only):
    """The filler's ``_group`` sends an over-budget frame (2^17 + 64
    triangles) down the counting-sort route, its lazy G-buffer too."""
    import cython3dmodelrenderer_tpu_torch as pt

    name, h, w, fov, tris, colors, normals, *_rest = frames()[-1]
    filler = pt.AdvancedPixelBufferFiller(h, w, fov=fov, device="cpu")
    assert filler._group == 16
    filler.render_arrays(*(torch.from_numpy(a) for a in (tris, normals, colors)),
                         post="lambert_u8", light=light_direction())
    np.testing.assert_array_equal(filler.get_post_image().numpy(),
                                  jax_frames[f"{name}/lambert"])
    assert_gbuffer_equal((filler.get_color_buffer(), filler.get_z_buffer(),
                          filler.get_normals_buffer()), jax_frames, f"{name}/")


# ---------------------------------------------------------------------------
# JAX reference (run as a script by ``jax_frames``)
# ---------------------------------------------------------------------------

def _jax_main(job_path, out_path):
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from cython3dmodelrenderer_tpu.config import RenderConfig
    from cython3dmodelrenderer_tpu.ops import binning, raster_pallas as rp
    from cython3dmodelrenderer_tpu.ops.projection import (project_to_screen,
                                                          visibility_masks)

    with np.load(job_path) as f:
        job = dict(f)
    light = jnp.asarray(job["light"])
    out = {}
    for key in [k for k in job if k.endswith("/hwf")]:
        name = key[:-4]
        h, w, fov = job[key]
        lean, group, ras = (int(v) for v in job[f"{name}/flags"])
        config = RenderConfig(height=int(h), width=int(w), fov=float(fov))
        tv, tc, tn = (jnp.asarray(job[f"{name}/{k}"])
                      for k in ("tris", "colors", "normals"))
        deg, back = visibility_masks(tv, tn)
        active = ~deg & ~back
        ts = project_to_screen(tv, config)
        if group > 1:       # sized as the JAX filler sizes (degrade mirror)
            slots = int(rp.grouped_slot_total(ts, active, config,
                                              group=group))
        else:
            slots = int(binning.plane_data(ts, active, config, rp.TILE_H,
                                           rp.TILE_W)[-1].sum())
        p_cap = binning.capacity_bucket(slots, 128)
        (color, z, normal), _cap, _act, img = rp.render_frame(
            tv, tn, tc, config, p_cap, 0, group=group, interpret=True,
            post="lambert_u8", light=light)
        out.update({f"{name}/color": color, f"{name}/z": z,
                    f"{name}/normal": normal, f"{name}/lambert": img})
        if lean:
            res = rp.render_frame(tv, tn, tc, config, p_cap, 0, group=group,
                                  interpret=True, post="u8", packed_out=True,
                                  emit_gbuf=False)
            out[f"{name}/u8"] = res[-1]
        if ras:
            for k, v in zip(("color", "z", "normal"),
                            rp.rasterize(ts, tc, tn, active, config,
                                         interpret=True)):
                out[f"{name}/rasterize/{k}"] = v
    np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})


if __name__ == "__main__":
    _jax_main(sys.argv[1], sys.argv[2])
