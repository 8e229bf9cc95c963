"""The plain reference against a brute-force NumPy pixel loop: every
pixel walks every triangle in ascending order with a strict-< depth
test, in float32 scalar arithmetic."""
import numpy as np
import pytest
import torch

from reference import render

F = np.float32


def scene(seed, n=14):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-0.6, 0.6, (n, 1, 3)) + [0.0, 0.0, 2.2]
    verts = (centers + rng.uniform(-0.5, 0.5, (n, 3, 3))).reshape(-1, 3)
    verts = verts.astype(np.float32)
    faces = np.arange(3 * n, dtype=np.int32).reshape(n, 3)
    faces[1::2] = faces[1::2, ::-1]                 # both windings
    faces = np.concatenate([faces, faces[:3]])      # exact ties
    normals = rng.normal(size=verts.shape).astype(np.float32)
    normals[:, 2] = -np.abs(normals[:, 2])          # mostly facing the eye
    normals[:6, 2] = 0.5                            # a few culled
    colors = rng.integers(0, 256, verts.shape).astype(np.float32)
    return verts, faces, normals, colors


def brute(verts, faces, normals, colors, cam, light, pose=None):
    w, h = cam["width"], cam["height"]
    pm = np.float32(render.projection_matrix(cam["fov"], h / w, cam["z_near"],
                                             cam["z_far"]))
    tv, tn, tc = verts[faces], normals[faces], colors[faces]
    if pose is not None:
        rt = render.rotation_transpose(pose[0]).numpy()
        sh = np.float32(pose[1])

        def turn(v):
            return np.stack([(v[..., 0] * rt[0, j] + v[..., 1] * rt[1, j])
                             + v[..., 2] * rt[2, j] for j in range(3)], -1)
        tv, tn = turn(tv) + sh, turn(tn)
    tris = []
    for t in range(len(faces)):
        v, n = tv[t], tn[t]
        e1, e2 = v[1, :2] - v[0, :2], v[2, :2] - v[0, :2]
        cross = e1[0] * e2[1] - e1[1] * e2[0]
        mean_nz = ((n[0, 2] + n[1, 2]) + n[2, 2]) / F(3.0)
        s = []
        for k in range(3):
            x, y, z = v[k]
            p = [((x * pm[0, j] + y * pm[1, j]) + z * pm[2, j]) + pm[3, j]
                 for j in range(4)]
            s.append(((p[0] / p[3] + F(1)) * F(w / 2), (p[1] / p[3] + F(1))
                      * F(h / 2), p[2] / p[3]))
        s = np.float32(s)
        planes = []
        for a, b, c in ((0, 1, 2), (1, 2, 0), (2, 0, 1)):
            (xa, ya), (xb, yb), (xc, yc) = s[a, :2], s[b, :2], s[c, :2]
            d = (xb - xc) * (ya - yc) - (yb - yc) * (xa - xc)
            planes.append((-(yb - yc) / d, (xb - xc) / d,
                           ((yb - yc) * xc - (xb - xc) * yc) / d))
        zp = [(planes[0][k] * s[0, 2] + planes[1][k] * s[1, 2])
              + planes[2][k] * s[2, 2] for k in range(3)]
        vals = tc[t] if light is None else np.concatenate([tc[t], tn[t]], 1)
        attrs = [[(planes[0][k] * vals[0, c] + planes[1][k] * vals[1, c])
                  + planes[2][k] * vals[2, c] for k in range(3)]
                 for c in range(vals.shape[1])]

        def clipped(u, hi):
            return 0 if np.isnan(u) else int(min(max(np.ceil(u), 0), hi))
        box = (clipped(s[:, 0].min(), w), clipped(s[:, 0].max(), w),
               clipped(s[:, 1].min(), h), clipped(s[:, 1].max(), h))
        live = cross != 0 and not mean_nz >= 0 and box[1] > box[0] \
            and box[3] > box[2]
        tris.append((live, planes, zp, attrs, box))
    image = np.zeros((h, w, 3), np.uint8)
    for y in range(h):
        for x in range(w):
            fx, fy, best, win = F(x), F(y), None, None
            for t, (live, planes, zp, _attrs, box) in enumerate(tris):
                if not (live and box[0] <= x < box[1] and box[2] <= y < box[3]):
                    continue
                if all(fx * a + (fy * b + c) >= 0 for a, b, c in planes):
                    z = fx * zp[0] + (fy * zp[1] + zp[2])
                    if 0 <= z <= 1 and (best is None or z < best):
                        best, win = z, t
            if win is None:
                continue
            ch = [fx * a + (fy * b + c) + F(0) for a, b, c in tris[win][3]]
            color = np.float32(ch[:3])
            if light is not None:
                nx, ny, nz = ch[3:]
                lx, ly, lz = np.float32(light)
                dot = ((nx * lx + F(0)) + ny * ly) + nz * lz
                sh = dot / (np.sqrt((nx * nx + ny * ny) + nz * nz) + F(1e-6))
                sh = F(0) if sh < 0 else F(1) if sh > 1 else sh
                color = color * sh
            image[y, x] = (color.astype(np.int32) & 255).astype(np.uint8)
    return image


CAM = {"width": 40, "height": 24, "fov": 45.0, "z_near": 0.1, "z_far": 1000.0}


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("lit", [False, True])
@pytest.mark.parametrize("posed", [False, True])
def test_reference_equals_brute_force(seed, lit, posed):
    verts, faces, normals, colors = scene(seed)
    light = render.frame_light([0.3, -0.2, 1.0]) if lit else None
    pose = ([5.0, 30.0 + seed, 0.0], [0.0, 0.0, 0.5]) if posed else None
    image, stats = render.render_view(
        *(torch.from_numpy(a) for a in (verts, faces, normals, colors)), CAM,
        light=light, pose=pose)
    expected = brute(verts, faces, normals, colors, CAM, light, pose)
    assert (expected > 0).any()
    np.testing.assert_array_equal(image.numpy(), expected)
    assert stats["triangles"] == len(faces)


def test_small_passes_give_the_same_image(monkeypatch):
    verts, faces, normals, colors = scene(3)
    args = [torch.from_numpy(a) for a in (verts, faces, normals, colors)]
    whole, stats = render.render_view(*args, CAM)
    monkeypatch.setattr(render, "FRAGMENTS_PER_PASS", 7)
    cut, cut_stats = render.render_view(*args, CAM)
    assert torch.equal(whole, cut) and stats == cut_stats


def test_bfloat16_differs():
    verts, faces, normals, colors = scene(4, n=40)
    args = [torch.from_numpy(a) for a in (verts, faces, normals, colors)]
    light = render.frame_light([0.0, 0.0, 1.0])
    exact, _ = render.render_view(*args, CAM, light=light)
    low, _ = render.render_view(*args, CAM, light=light, dtype=torch.bfloat16)
    assert (exact != low).any(-1).sum() > 0
