"""Port scene layer (OBJ loader, Model, transforms, Buffer) against JAX.

Loader arrays must be equal. Transforms are compared within atol=1e-6:
the JAX package jits them, and XLA:CPU contracts multiply-adds into FMAs
and evaluates sin/cos with its own polynomials, while the port writes each
product out in a fixed order (an ulp or two, ~2e-7, apart). Vertex normals
computed from the SAME vertices agree within the same bound.
"""
import numpy as np
import pytest
import torch

import cython3dmodelrenderer_tpu as jx
from cython3dmodelrenderer_tpu.models import obj_io as jax_obj_io
from cython3dmodelrenderer_tpu.ops import transforms as jax_transforms

import cython3dmodelrenderer_tpu_torch as pt
from cython3dmodelrenderer_tpu_torch.models import obj_io
from cython3dmodelrenderer_tpu_torch.ops import transforms

ASSETS = ["cube_path", "cube2_path", "igor_sphere_path"]
ATOL = 1e-6


def jax_state(model):
    return {"vertices": np.asarray(model._vertices),
            "faces_v": np.asarray(model._faces_v),
            "normals": np.asarray(model._normals),
            "faces_n": np.asarray(model._faces_n)}


def pose(model, fit=True):
    model.rotate([-90, 180, 0])
    model.rotate([10, -80, 0])
    if fit:
        (jx.fit_model if isinstance(model, jx.Model) else pt.fit_model)(model)
    return model


@pytest.mark.parametrize("asset", ASSETS)
def test_load_obj_matches_jax(asset, request):
    path = request.getfixturevalue(asset)
    got = obj_io.load_obj(path)
    want = jax_obj_io.load_obj(path)
    for field in ("vertices", "texture_coords", "normals", "faces_v",
                  "faces_vt", "faces_vn", "texture"):
        a, b = getattr(got, field), getattr(want, field)
        assert (a is None) == (b is None), field
        if a is not None:
            assert a.dtype == b.dtype, field
            np.testing.assert_array_equal(a, b, err_msg=field)


def test_strict_parse_raises(tmp_path):
    bad = tmp_path / "bad.obj"
    bad.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 x\n")
    with pytest.raises(RuntimeError, match="malformed OBJ line"):
        obj_io.load_obj(str(bad), silent=False)
    assert len(obj_io.load_obj(str(bad)).faces_v) == 0     # lenient default


@pytest.mark.parametrize("asset", ASSETS)
def test_pose_and_fit_match_jax(asset, request):
    path = request.getfixturevalue(asset)
    jm = pose(jx.Model.read_model(path))
    pm = pose(pt.Model.read_model(path, device="cpu"))
    np.testing.assert_allclose(pm.vertices.numpy(), np.asarray(jm.vertices),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(pm.get_mean_vertex(), jm.get_mean_vertex(),
                               rtol=0, atol=ATOL)
    assert abs(pm.get_max_span() - jm.get_max_span()) <= ATOL


@pytest.mark.parametrize("asset", ASSETS)
def test_vertex_normals_match_jax(asset, request):
    """Same posed vertices on both sides → normals within 1e-6. (The pole
    vertex of igor_sphere has 64 nearly parallel face normals, so the
    1e-6 dedup rule can flip on vertices that differ by an ulp: the check
    feeds both sides identical vertices.)"""
    jm = pose(jx.Model.read_model(request.getfixturevalue(asset)), fit=False)
    v, f = np.array(jm._vertices), np.array(jm._faces_v)
    inc, valid = transforms.build_incidence(f, len(v))
    jinc, jvalid = jax_transforms.build_incidence(f, len(v))
    np.testing.assert_array_equal(inc, jinc)
    got = transforms.vertex_normals(torch.from_numpy(v), torch.from_numpy(f),
                                    torch.from_numpy(inc), torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.normals),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("asset", ["cube_path", "cube2_path"])
def test_model_normals_after_pose_match_jax(asset, request):
    path = request.getfixturevalue(asset)
    jm = pose(jx.Model.read_model(path))
    pm = pose(pt.Model.read_model(path, device="cpu"))
    np.testing.assert_allclose(pm.normals_by_triangles.numpy(),
                               np.asarray(jm.normals_by_triangles),
                               rtol=0, atol=ATOL)


def test_face_normals_of_repeated_vertices_are_zero():
    tri = torch.tensor([[[0.1, 0.2, 1.0], [0.1, 0.2, 1.0], [0.5, 0.3, 1.0]],
                        [[0.0, 0.0, 1.0], [1.0, 0.0, 1.0], [0.0, 1.0, 1.0]]])
    n = transforms.face_normals(tri)
    assert n[0].abs().max() == 0 and abs(float(n[1].norm()) - 1) < 1e-6


@pytest.mark.parametrize("asset", ASSETS)
def test_from_state_holds_the_jax_arrays(asset, request):
    jm = pose(jx.Model.read_model(request.getfixturevalue(asset)))
    pm = pt.Model.from_state(jax_state(jm), device="cpu")
    for got, want in ((pm.vertices_by_triangles, jm.vertices_by_triangles),
                      (pm.normals_by_triangles, jm.normals_by_triangles)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert pm.colors_by_triangles is None
    assert pm.n_triangles() == jm.n_triangles()
    assert pm.n_vertices() == jm.n_vertices()


def test_texture_presampling_matches_jax():
    rng = np.random.RandomState(4)
    verts = rng.rand(6, 3).astype(np.float32)
    faces = np.array([[0, 1, 2], [3, 4, 5], [0, 2, 4]], np.int32)
    tc = rng.uniform(-0.1, 1.1, (6, 2)).astype(np.float32)
    tex = rng.randint(0, 256, (7, 5, 3)).astype(np.uint8)
    kw = dict(texture_coords=tc, triangles_texture_coords=faces, texture=tex)
    jm = jx.Model(verts, faces, **kw)
    pm = pt.Model(verts, faces, **kw, device="cpu")
    np.testing.assert_array_equal(pm.colors_by_triangles.numpy(),
                                  np.asarray(jm.colors_by_triangles))
    vt, colors, normals = pm.get_triangle(1)
    jvt, jcolors, _ = jm.get_triangle(1)
    np.testing.assert_array_equal(vt, jvt)
    np.testing.assert_array_equal(colors, jcolors)


def test_shift_and_scale_match_jax(cube_path):
    jm, pm = jx.Model.read_model(cube_path), pt.Model.read_model(
        cube_path, device="cpu")
    for m in (jm, pm):
        m.shift([0.25, -1.5, 3.0])
        m.scale(0.37)
        m.scale(2.0, keep_position=False)
    np.testing.assert_allclose(pm.vertices.numpy(), np.asarray(jm.vertices),
                               rtol=0, atol=ATOL)


def test_depth_iterator_matches_jax(igor_sphere_path):
    jm = pose(jx.Model.read_model(igor_sphere_path))
    pm = pt.Model.from_state(jax_state(jm), device="cpu")
    np.testing.assert_array_equal(pt.DepthIterator.order_indices(pm).numpy(),
                                  np.asarray(jx.DepthIterator.order_indices(jm)))


def test_buffer_api_and_checkpoint(tmp_path):
    buf = pt.Buffer(4, 8, dim=3, dtype="float32", init_val=7, device="cpu")
    assert buf.get_size() == (4, 8) and buf.get_image()[0, 0, 0] == 7
    buf.set_pixel(2, 1, [1, 2, 3])
    np.testing.assert_array_equal(buf.get_pixel(2, 1), [1, 2, 3])
    buf.set_pixel(100, 100, [9, 9, 9])                       # silently dropped
    buf[0, 0] = [5, 5, 5]
    np.testing.assert_array_equal(buf[0, 0], [5, 5, 5])
    buf.save(str(tmp_path / "b.npz"))
    back = pt.Buffer.load(str(tmp_path / "b.npz"), device="cpu")
    np.testing.assert_array_equal(back.get_image(), buf.get_image())
    buf.clear()
    assert buf.get_image()[2, 1, 0] == 7
    lazy = pt.Buffer(2, 2, dim=1, device="cpu")
    calls = []
    lazy.set_lazy(lambda: calls.append(1) or torch.full((2, 2, 1), 3.0))
    assert not calls and lazy.get_image().max() == 3 and calls == [1]
    lazy.get_image()
    assert calls == [1]
    with pytest.raises(ValueError):
        lazy.array = torch.zeros(3, 3, 1)
