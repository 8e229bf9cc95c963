"""Port sharded rendering (``parallel.mesh``, the three sharded functions of
``parallel.multiview``, ``examples.multichip``) against the JAX package.

The port runs one process a rank: for each world size D in ``WORLDS`` one
spawn of D gloo ranks (``torch.multiprocessing``; the process group meets
through a file, FileStore, so concurrent test workers never share a port)
runs every case and saves each rank's results. Every rank passes the same
full inputs, as JAX replicates them.

The JAX side runs the JAX package's own ``render_turntable_sharded`` /
``render_triangle_sharded`` on 8 virtual CPU devices
(``--xla_force_host_platform_device_count=8``) without FMA contraction
(``--xla_cpu_max_isa=AVX``, see ``test_torch_raster.py``), in two
subprocesses that run beside the spawns: ``"jnp"`` at D = 2, 4, 8 against
the port's ``"ratio"``, and ``"pallas", interpret=True`` against the
port's ``"torch"`` at one mesh size (the triangle-sharded interpret run
takes ~30 s): a view-sharded output is the same array on any mesh size,
and a triangle-sharded one too (the merge keeps the winning shard's z,
its zero's sign included). Every comparison is bit for bit. JAX's own rotation
matrices (built inside ``jit``) are patched into the port as in
``test_torch_multiview.py``.

The ±0.0 merge rule is held with hand-made partial frames: each side's
``render_view`` is replaced by a lookup of shard r's (colour, z, normal),
with z drawn from {-0.0, +0.0, 0.5, 1e6} so the shards tie at ±0.0, and
JAX's and the port's whole ``render_triangle_sharded`` merge them.
Scenes: ``tests/test_multiview.py``'s tiny scenes at 64².
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from test_torch_multiview import CONFIG, tiny_scene, torch_scene
from test_torch_raster import REPO

from cython3dmodelrenderer_tpu_torch.examples import multichip
from cython3dmodelrenderer_tpu_torch.ops import raster
from cython3dmodelrenderer_tpu_torch.parallel import multiview
from cython3dmodelrenderer_tpu_torch.parallel.mesh import make_mesh

WORLDS = (2, 4, 8)
N_VIEWS = 8
MERGE_HW = (6, 20)
P_CAPS = (256, 1)            # the JAX overflow test's p_cap; below any demand
Z_SHIFT = np.float32([0.0, 0.0, 1.0])


def scenes():
    """The JAX tests' scenes (``tests/test_multiview.py``) as numpy arrays:
    A view-sharded jnp (``:51``), B view-sharded pallas (``:87``), C
    triangle-sharded jnp (``:64``), E triangle-sharded pallas (``:124``),
    F the overflow scene (``:414``)."""
    c, e = tiny_scene(32, 3), tiny_scene(32, 7)
    return {"A": tiny_scene(16, 0), "B": tiny_scene(32, 5),
            "C": (c[0] + Z_SHIFT, c[1], c[2]), "E": (e[0] + Z_SHIFT, e[1], e[2]),
            "F": tiny_scene(48, 3)}


def merge_tables(n_dev):
    """Hand-made partial frames of ``n_dev`` shards: (colour, z, normal),
    each (D, H, W, C) float32; z ties across shards at -0.0 and +0.0, and
    colours and normals hold -0.0."""
    rng = np.random.RandomState(100 + n_dev)
    h, w = MERGE_HW
    levels = np.float32([-0.0, 0.0, 0.5, 1e6])
    z = levels[rng.randint(0, 4, (n_dev, h, w, 1))]
    color = rng.uniform(-5, 5, (n_dev, h, w, 3)).astype(np.float32)
    normal = rng.uniform(-1, 1, (n_dev, h, w, 3)).astype(np.float32)
    color[rng.rand(*color.shape) < 0.3] = -0.0
    normal[rng.rand(*normal.shape) < 0.3] = -0.0
    return color, z, normal


def merge_scene(n_dev):
    """One triangle a shard whose vertices hold the shard's index, which the
    stand-in ``render_view`` reads to pick its partial frame."""
    tv = np.repeat(np.arange(n_dev, dtype=np.float32), 9).reshape(n_dev, 3, 3)
    return tv, np.zeros_like(tv), np.zeros_like(tv)


def rotation_table(out):
    return {out[k.replace("rot/", "rot_angle/")].astype(np.float32).tobytes():
            out[k] for k in out if k.startswith("rot/")}


def patch_rotations(table, setattr_=setattr):
    """Use JAX's rotation matrices in ``multiview`` (see module docstring)."""
    def rotation_matrix(angles, degrees=True, device=None):
        assert degrees
        return torch.from_numpy(
            table[np.asarray(angles, np.float32).tobytes()]).to(device)

    setattr_(multiview, "rotation_matrix", rotation_matrix)


def bits(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_bit_equal(got, want):
    got, want = (x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
                 for x in (got, want))
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(bits(got), bits(want))


# ---------------------------------------------------------------------------
# one rank of a spawn (runs in a child process)
# ---------------------------------------------------------------------------

def _expect_value_error(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def rank_cases(rank, world):
    """Every case at this world size, in the same order on every rank (the
    collectives pair up); returns the rank's results as numpy arrays."""
    out = {}
    sc = {k: torch_scene(*v) for k, v in scenes().items()}
    angles = multiview.turntable_angles(N_VIEWS)

    views = make_mesh([("views", world)], device="cpu")
    out["mesh/views"] = np.int64([views.shape[0], views.get_local_rank("views")])
    out["mesh/too_big"] = _expect_value_error(
        lambda: make_mesh([("views", world + 1)], device="cpu"))

    out["tt_ratio"] = multiview.render_turntable_sharded(
        *sc["A"], angles, CONFIG, views, bbox_size=32, chunk=16)
    out["tt_torch"], out["tt_torch/peak"] = multiview.render_turntable_sharded(
        *sc["B"], angles, CONFIG, views, backend="torch", check_capacity=True)
    if (N_VIEWS // world) % 2 == 0:
        out["tt_torch_vb2"], out["tt_torch_vb2/peak"] = \
            multiview.render_turntable_sharded(
                *sc["B"], angles, CONFIG, views, backend="torch",
                view_batch=2, check_capacity=True)
    out["tt_ample"], out["tt_ample/peak"] = multiview.render_turntable_sharded(
        *sc["F"], angles, CONFIG, views, backend="torch", check_capacity=True)
    for cap in P_CAPS:
        out[f"tt_cap{cap}"], out[f"tt_cap{cap}/peak"] = \
            multiview.render_turntable_sharded(
                *sc["F"], angles, CONFIG, views, backend="torch", p_cap=cap,
                check_capacity=True)
    out["err/views"] = _expect_value_error(
        lambda: multiview.render_turntable_sharded(
            *sc["A"], multiview.turntable_angles(world + 1), CONFIG, views))
    out["err/view_batch"] = _expect_value_error(
        lambda: multiview.render_turntable_sharded(
            *sc["A"], angles, CONFIG, views, view_batch=2))

    tris = make_mesh([("tris", world)], device="cpu")
    color, z, normal = multiview.render_triangle_sharded(
        *sc["C"], CONFIG, tris, bbox_size=32, chunk=4)
    out.update({"tri_ratio/color": color, "tri_ratio/z": z,
                "tri_ratio/normal": normal})
    color, z, normal, used = multiview.render_triangle_sharded(
        *sc["E"], CONFIG, tris, backend="torch", check_capacity=True)
    out.update({"tri_torch/color": color, "tri_torch/z": z,
                "tri_torch/normal": normal, "tri_torch/used": used})
    out["tri_capacity"] = multiview.triangle_shard_capacity(
        sc["E"][0], sc["E"][1], CONFIG, tris)
    odd = [x[:world + 1] for x in sc["C"]]
    out["err/tris"] = _expect_value_error(
        lambda: multiview.render_triangle_sharded(*odd, CONFIG, tris))

    tables = [torch.from_numpy(t) for t in merge_tables(world)]
    real_view = multiview.render_view
    multiview.render_view = lambda tv, *a, **k: tuple(
        t[int(tv[0, 0, 0])] for t in tables)
    try:
        merged = multiview.render_triangle_sharded(
            *torch_scene(*merge_scene(world)), CONFIG, tris)
    finally:
        multiview.render_view = real_view
    out.update({f"merge/{k}": v for k, v in zip(("color", "z", "normal"),
                                                 merged)})

    if world >= 4:
        grid = make_mesh([("views", world // 2), ("tris", 2)], device="cpu")
        out["mesh/grid"] = np.int64([grid.get_local_rank("views"),
                                     grid.get_local_rank("tris")])
        out["tt_grid"] = multiview.render_turntable_sharded(
            *sc["A"], angles, CONFIG, grid, axis="views", bbox_size=32,
            chunk=16)
    return {k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in out.items()}


def rank_main(rank, world, init_file, out_dir, rot_path):
    torch.set_num_threads(1)
    with np.load(rot_path) as rot:
        patch_rotations(rotation_table(dict(rot)))
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        out = rank_cases(rank, world)
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


# ---------------------------------------------------------------------------
# the runs: JAX subprocesses beside one spawn per world size
# ---------------------------------------------------------------------------

def start_jax(part, tmp):
    """This file as a script on ``part`` in a subprocess (JAX on the CPU,
    8 devices, no FMA contraction); returns (process, output path)."""
    out_path = tmp / f"jax_{part}.npz"
    env = dict(os.environ)
    flags = env.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        flags += " --xla_force_host_platform_device_count=8"
    env["XLA_FLAGS"] = (flags + " --xla_cpu_max_isa=AVX").strip()
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join([REPO, env.get("PYTHONPATH", "")])
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), part,
                             str(out_path)], env=env, cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, out_path


def finish_jax(proc, out_path):
    stdout, stderr = proc.communicate(timeout=900)
    assert proc.returncode == 0, stdout[-2000:] + stderr[-4000:]
    with np.load(out_path) as out:
        return dict(out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"jax": the JAX outputs, "ranks": {D: [rank 0's results, ...]}}."""
    tmp = tmp_path_factory.mktemp("sharded")
    rot_job = start_jax("rot", tmp)
    jobs = [start_jax(part, tmp) for part in ("main", "tri_pallas")]
    finish_jax(*rot_job)
    spawns = {}
    for world in WORLDS:
        out_dir = tmp / f"world{world}"
        out_dir.mkdir()
        spawns[world] = (out_dir, mp.spawn(
            rank_main, args=(world, str(out_dir / "pg"), str(out_dir),
                             str(rot_job[1])), nprocs=world, join=False))
    jax_out = {}
    for job in jobs:
        jax_out.update(finish_jax(*job))
    ranks = {}
    for world, (out_dir, ctx) in spawns.items():
        while not ctx.join(timeout=900):
            pass
        ranks[world] = []
        for r in range(world):
            with np.load(out_dir / f"rank{r}.npz") as f:
                ranks[world].append(dict(f))
    with np.load(rot_job[1]) as rot:
        jax_out.update(rot)
    return {"jax": jax_out, "ranks": ranks}


@pytest.fixture
def jax_rotations(runs, monkeypatch):
    patch_rotations(rotation_table(runs["jax"]), monkeypatch.setattr)


def gathered(ranks, key):
    return np.concatenate([r[key] for r in ranks])


def same_on_every_rank(ranks, key):
    for r in ranks[1:]:
        assert_bit_equal(r[key], ranks[0][key])
    return ranks[0][key]


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_make_mesh_axes_and_world_size(runs, world):
    """1-D meshes span every rank in rank order; a 2-D views x tris mesh
    puts rank r at (r // 2, r % 2); a mesh that does not match the world
    size raises."""
    ranks = runs["ranks"][world]
    for r, res in enumerate(ranks):
        assert res["mesh/views"].tolist() == [world, r]
        assert "needs" in str(res["mesh/too_big"])
        if world >= 4:
            assert res["mesh/grid"].tolist() == [r // 2, r % 2]


@pytest.mark.parametrize("world", WORLDS)
def test_view_sharded_ratio_matches_jax(runs, world, jax_rotations):
    """``render_turntable_sharded`` on ``"ratio"`` against JAX ``"jnp"`` on
    the same mesh size: rank r holds views [r·N/D, (r+1)·N/D), gathered
    bit-equal to JAX's and to the port's unsharded ``render_turntable``."""
    ranks = runs["ranks"][world]
    assert ranks[0]["tt_ratio"].shape == (N_VIEWS // world, 64, 64, 3)
    got = gathered(ranks, "tt_ratio")
    assert_bit_equal(got, runs["jax"][f"tt_jnp/{world}"])
    tv, tn, tc = torch_scene(*scenes()["A"])
    assert_bit_equal(got, multiview.render_turntable(
        tv, tn, tc, multiview.turntable_angles(N_VIEWS), CONFIG,
        bbox_size=32, chunk=16))
    assert got.max() > 0


@pytest.mark.parametrize("world", WORLDS)
def test_view_sharded_torch_matches_jax(runs, world, jax_rotations):
    """The kernel backend's plain versions against JAX ``"pallas"`` in
    interpret mode, one view a device and, where each rank has 2 or more
    views, ``view_batch=2`` against JAX's 4-device batched sweep."""
    ranks = runs["ranks"][world]
    assert_bit_equal(gathered(ranks, "tt_torch"), runs["jax"]["tt_pallas"])
    if (N_VIEWS // world) % 2 == 0:
        assert_bit_equal(gathered(ranks, "tt_torch_vb2"),
                         runs["jax"]["tt_pallas_vb2"])


@pytest.mark.parametrize("world", WORLDS)
def test_view_sharded_check_capacity_is_the_mesh_max(runs, world,
                                                     jax_rotations):
    """Every rank gets the mesh maximum of the ranks' peak per-batch pair
    totals: the unsharded sweep's peak at the same ``view_batch``."""
    tv, tn, tc = torch_scene(*scenes()["B"])
    angles = multiview.turntable_angles(N_VIEWS)
    for key, vb in (("tt_torch", 1), ("tt_torch_vb2", 2)):
        if f"{key}/peak" not in runs["ranks"][world][0]:
            continue
        want = multiview.render_turntable_pallas(
            tv, tn, tc, angles, CONFIG, view_batch=vb, check_capacity=True,
            backend="torch")[1]
        assert int(same_on_every_rank(runs["ranks"][world],
                                      f"{key}/peak")) == want > 0


@pytest.mark.parametrize("world", WORLDS)
def test_view_sharded_p_cap_has_no_effect(runs, world):
    """``test_multiview.py:407``'s overflow case: ``p_cap=256`` (JAX's
    undersized bucket; the port's demand on this scene is a pair total) and
    ``p_cap=1``, below any demand, give the frames and the peak of the
    default (the port sizes each batch exactly)."""
    ranks = runs["ranks"][world]
    ample = int(same_on_every_rank(ranks, "tt_ample/peak"))
    assert ample > 1
    for cap in P_CAPS:
        assert_bit_equal(gathered(ranks, f"tt_cap{cap}"),
                         gathered(ranks, "tt_ample"))
        assert int(same_on_every_rank(ranks, f"tt_cap{cap}/peak")) == ample


@pytest.mark.parametrize("world", [w for w in WORLDS if w >= 4])
def test_view_sharded_over_one_axis_of_a_2d_mesh(runs, world):
    """On a views x tris mesh the ranks along ``tris`` render the same
    views; the views gathered along ``views`` equal JAX's sweep."""
    ranks = runs["ranks"][world]
    for r in range(0, world, 2):
        assert_bit_equal(ranks[r + 1]["tt_grid"], ranks[r]["tt_grid"])
    got = np.concatenate([ranks[r]["tt_grid"] for r in range(0, world, 2)])
    assert_bit_equal(got, runs["jax"][f"tt_jnp/{world}"])


@pytest.mark.parametrize("world", WORLDS)
def test_triangle_sharded_ratio_matches_jax(runs, world):
    """``render_triangle_sharded`` on ``"ratio"`` against JAX ``"jnp"`` on
    the same mesh size: every rank returns the same merged colour, z and
    normal, bit-equal to JAX's."""
    ranks = runs["ranks"][world]
    for part in ("color", "z", "normal"):
        got = same_on_every_rank(ranks, f"tri_ratio/{part}")
        assert_bit_equal(got, runs["jax"][f"tri_jnp/{world}/{part}"])


@pytest.mark.parametrize("world", WORLDS)
def test_triangle_sharded_torch_matches_jax(runs, world):
    """The kernel backend's plain versions against JAX ``"pallas"`` in
    interpret mode (8 devices)."""
    ranks = runs["ranks"][world]
    for part in ("color", "z", "normal"):
        got = same_on_every_rank(ranks, f"tri_torch/{part}")
        assert_bit_equal(got, runs["jax"][f"tri_pallas/{part}"])
    assert (runs["jax"]["tri_pallas/z"] < CONFIG.z_init).mean() > 0.1


@pytest.mark.parametrize("world", WORLDS)
def test_triangle_sharded_z_equals_unsharded(runs, world):
    """Shards hold contiguous triangle ranges, so the merged z is the
    unsharded frame's z bit for bit, on both backends; colour and normal
    equal the unsharded frame's with a winner's -0.0 read as +0.0."""
    ranks = runs["ranks"][world]
    sc = scenes()
    (color, z, normal), _img, _n = raster.render_frame(
        *torch_scene(*sc["E"]), CONFIG, post="none")
    color = multiview.lambert_shade(color, normal, multiview._norm_light(
        (0.0, 0.0, 1.0)))
    assert_bit_equal(ranks[0]["tri_torch/z"], z)
    assert_bit_equal(ranks[0]["tri_torch/color"], color + 0.0)
    assert_bit_equal(ranks[0]["tri_torch/normal"], normal + 0.0)
    _c, z_ratio, _nn = multiview.render_view(*torch_scene(*sc["C"]), CONFIG,
                                             bbox_size=32, chunk=4)
    assert_bit_equal(ranks[0]["tri_ratio/z"], z_ratio)


@pytest.mark.parametrize("world", WORLDS)
def test_triangle_shard_capacity_is_the_mesh_max(runs, world):
    """``triangle_shard_capacity`` = the largest shard's pair total x 5 // 4;
    ``check_capacity`` returns that largest total on every rank."""
    tv, tn, tc = torch_scene(*scenes()["E"])
    per = tv.shape[0] // world
    totals = [raster.render_frame(tv[i:i + per], tn[i:i + per],
                                  tc[i:i + per], CONFIG, post="none")[2]
              for i in range(0, tv.shape[0], per)]
    ranks = runs["ranks"][world]
    assert int(same_on_every_rank(ranks, "tri_torch/used")) == max(totals) > 0
    assert int(same_on_every_rank(ranks, "tri_capacity")) == max(totals) * 5 // 4


@pytest.mark.parametrize("world", WORLDS)
def test_zero_tie_merge_against_jax(runs, world):
    """The merge on hand-made partial frames whose shards tie at z = -0.0
    and +0.0 (module docstring), against JAX's ``render_triangle_sharded``
    merging the same frames: colour, normal and z bit-equal at every
    pixel. Where the minimum is a zero held with both signs, XLA:CPU's
    ``pmin`` returns the lowest tied shard's zero (the winner's); the
    port's merge sums ``where(win, z, -0.0)``, the winner's zero too."""
    ranks = runs["ranks"][world]
    _color, z, _normal = merge_tables(world)
    for part in ("color", "normal", "z"):
        got = same_on_every_rank(ranks, f"merge/{part}")
        assert_bit_equal(got, runs["jax"][f"merge/{world}/{part}"])
    zs = z[..., 0]
    signed_tie = ((zs.min(0) == 0) & (np.signbit(zs) & (zs == 0)).any(0)
                  & (~np.signbit(zs) & (zs == 0)).any(0))
    assert signed_tie.sum() > 0


@pytest.mark.parametrize("world", WORLDS)
def test_shards_must_divide(runs, world):
    """JAX's asserts: D divides the views and the triangles; ``view_batch``
    needs a kernel backend."""
    res = runs["ranks"][world][0]
    assert "must divide" in str(res["err/views"])
    assert "must divide" in str(res["err/tris"])
    assert "kernel backend" in str(res["err/view_batch"])


def test_world_of_one_in_process(tmp_path):
    """World size 1 in this process: both sharded functions equal the
    unsharded render bit for bit (the merge's sum of one rank is the
    identity, so -0.0 survives), and the capacity is the frame's total."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh([("views", 1)], device="cpu")
        tv, tn, tc = torch_scene(*tiny_scene(24, 9))
        angles = multiview.turntable_angles(4)
        got, peak = multiview.render_turntable_sharded(
            tv, tn, tc, angles, CONFIG, mesh, backend="torch", view_batch=2,
            check_capacity=True)
        want, want_peak = multiview.render_turntable_pallas(
            tv, tn, tc, angles, CONFIG, view_batch=2, check_capacity=True)
        assert_bit_equal(got, want)
        assert peak == want_peak
        tv2 = tv + torch.from_numpy(Z_SHIFT)
        color, z, normal, used = multiview.render_triangle_sharded(
            tv2, tn, tc, CONFIG, mesh, axis="views", backend="torch",
            check_capacity=True)
        (c0, z0, n0), _img, total = raster.render_frame(
            tv2, tn, tc, CONFIG, post="none")
        c0 = multiview.lambert_shade(c0, n0, multiview._norm_light((0, 0, 1)))
        for a, b in ((color, c0), (z, z0), (normal, n0)):
            assert_bit_equal(a, b)
        assert used == total and multiview.triangle_shard_capacity(
            tv2, tn, CONFIG, mesh, axis="views", headroom_num=1,
            headroom_den=1) == total
    finally:
        dist.destroy_process_group()


def test_make_mesh_defaults_to_the_card():
    """No device means the card: without CUDA ``make_mesh`` raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh([("views", 1)])


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh([("views", 1)], device="cpu")


def test_multichip_example_on_cpu(capfd):
    """``examples.multichip`` at 4 ranks (a 2 x 2 mesh) on the CPU: its own
    content checks (sharded == unsharded, bit for bit) pass on every rank."""
    multichip.main(4, "cpu")
    out = capfd.readouterr().out
    assert "mesh views=2 x tris=2" in out
    assert out.count("== the unsharded") == 4


# ---------------------------------------------------------------------------
# JAX reference (run as a script by ``runs``)
# ---------------------------------------------------------------------------

def _jax_main(part, out_path):
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from cython3dmodelrenderer_tpu.config import RenderConfig as JConfig
    from cython3dmodelrenderer_tpu.ops.transforms import rotation_matrix
    from cython3dmodelrenderer_tpu.parallel import multiview as mv
    from cython3dmodelrenderer_tpu.parallel.mesh import make_mesh as jmesh

    cfg = JConfig(height=CONFIG.height, width=CONFIG.width, fov=CONFIG.fov)
    sc = {k: [jnp.asarray(a) for a in v] for k, v in scenes().items()}
    angles = mv.turntable_angles(N_VIEWS)
    out = {}
    if part == "rot":
        rot = jax.jit(rotation_matrix)
        for a in np.asarray(angles):
            key = a.tobytes().hex()
            out[f"rot/{key}"], out[f"rot_angle/{key}"] = rot(jnp.asarray(a)), a
    elif part == "tri_pallas":
        res = mv.render_triangle_sharded(*sc["E"], cfg, jmesh([("tris", 8)]),
                                         backend="pallas", interpret=True)
        out.update({f"tri_pallas/{k}": v
                    for k, v in zip(("color", "z", "normal"), res)})
    else:
        for d in WORLDS:
            views, tris = jmesh([("views", d)]), jmesh([("tris", d)])
            out[f"tt_jnp/{d}"] = mv.render_turntable_sharded(
                *sc["A"], angles, cfg, views, bbox_size=32, chunk=16)
            res = mv.render_triangle_sharded(*sc["C"], cfg, tris,
                                             bbox_size=32, chunk=4)
            out.update({f"tri_jnp/{d}/{k}": v
                        for k, v in zip(("color", "z", "normal"), res)})
            tables = [jnp.asarray(t) for t in merge_tables(d)]
            real_view = mv.render_view
            mv.render_view = lambda tv, *a, **k: tuple(
                t[tv[0, 0, 0].astype(jnp.int32)] for t in tables)
            try:
                res = mv.render_triangle_sharded(
                    *[jnp.asarray(a) for a in merge_scene(d)], cfg, tris)
            finally:
                mv.render_view = real_view
            out.update({f"merge/{d}/{k}": v
                        for k, v in zip(("color", "z", "normal"), res)})
        out["tt_pallas"] = mv.render_turntable_sharded(
            *sc["B"], angles, cfg, jmesh([("views", 8)]), backend="pallas",
            interpret=True)
        out["tt_pallas_vb2"] = mv.render_turntable_sharded(
            *sc["B"], angles, cfg, jmesh([("views", 4)]), backend="pallas",
            interpret=True, view_batch=2)
    np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})


if __name__ == "__main__":
    _jax_main(sys.argv[1], sys.argv[2])
