"""``correct`` on the CPU at small shapes: sound runs of every cell come
out correct; the control (the reference in bfloat16 in the program's
place) and each fault a cell can have, planted in the program under the
timed path, come out not correct. The look for a chip is skipped: the
runs drive ``harness.run`` on the CPU, where the program runs its plain
versions. (One chip: no exchange between chips to leave out.)"""
import time

import pytest
import torch

import harness

SMALL_MESH = {"trex14k": {"builder": "displaced_sphere", "segments": 24,
                          "rings": 12},
              "igor6k": {"builder": "displaced_sphere", "segments": 16,
                         "rings": 10}}
SMALL_TRAFFIC = {"size": 80, "poses": 4, "views": 8, "view_batch": 4,
                 "trace_steps": 2}
#: the benchmark's cells and the shelved sweeps, which keep their driver
CELLS = [w["name"] for w in harness.catalog(shelved=True)["workloads"]]


def small_run(cell, seed=2 ** 33 + 7, trace=False, control=None):
    return harness.run(
        cell, seed, 1.0, trace, started=time.perf_counter(), device="cpu",
        config_overrides={"mesh": SMALL_MESH[cell.split(".")[0]]},
        traffic_overrides=SMALL_TRAFFIC, control=control, shelved=True,
        log=lambda m: None)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    result = small_run(cell)
    assert result["correct"], result["checks"]
    assert result["checks"]["worst_image_px"]["value"] == 0
    assert list(result)[-1] == "checks"
    assert result["attempted"] > 0 and result["failed"] == 0


@pytest.mark.parametrize("cell", ["igor6k.frames1024",
                                  "trex14k.turntable64_vb8"])
def test_traced_run_reads_its_metrics(cell):
    result = small_run(cell, trace=True)
    assert result["correct"]
    assert result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    unit = "frames" if "frames" in cell else "sweep"
    assert f"launch_calls.{unit}" in result["metrics"]


@pytest.mark.parametrize("cell", ["igor6k.frames1024",
                                  "trex14k.turntable64_vb8"])
def test_control_is_not_correct(cell):
    result = small_run(cell, control=torch.bfloat16)
    assert not result["correct"]
    assert result["checks"]["worst_image_px"]["value"] > 0


def stale_frames(monkeypatch):
    """Each frame delivers the image of the frame before it."""
    from cython3dmodelrenderer_tpu_torch import AdvancedPixelBufferFiller

    get, last = AdvancedPixelBufferFiller.get_post_image, []

    def stale(self):
        image = get(self)
        last.append(image)
        return last[-2] if len(last) > 1 else image
    monkeypatch.setattr(AdvancedPixelBufferFiller, "get_post_image", stale)


def half_frame(monkeypatch):
    """Half of the frame's triangles are left out."""
    from cython3dmodelrenderer_tpu_torch.ops import raster

    render = raster.render_frame

    def half(tri_verts, tri_norms, tri_colors, *args, **kwargs):
        n = tri_verts.shape[0] // 2
        return render(tri_verts[:n], tri_norms[:n], tri_colors[:n], *args,
                      **kwargs)
    monkeypatch.setattr(raster, "render_frame", half)


def altered_frame(monkeypatch):
    """One pixel of each frame is altered where the image is produced."""
    from cython3dmodelrenderer_tpu_torch.ops import raster

    tiles = raster.raster_tiles_plain

    def altered(*args, **kwargs):
        gbuf, image = tiles(*args, **kwargs)
        if image is not None:
            image = image.clone()
            image.view(-1)[7] ^= 1
        return gbuf, image
    monkeypatch.setattr(raster, "raster_tiles_plain", altered)


def stale_sweep(monkeypatch):
    """Each view batch delivers the batch before it."""
    from cython3dmodelrenderer_tpu_torch.parallel import multiview

    batch, last = multiview._render_view_batch, []

    def stale(*args, **kwargs):
        out = batch(*args, **kwargs)
        last.append(out)
        return last[-2] if len(last) > 1 else out
    monkeypatch.setattr(multiview, "_render_view_batch", stale)


def half_batch(monkeypatch):
    """Half of each view batch is left out (its views left black)."""
    from cython3dmodelrenderer_tpu_torch.parallel import multiview

    batch = multiview._render_view_batch

    def half(*args, **kwargs):
        images, total = batch(*args, **kwargs)
        images = images.clone()
        images[images.shape[0] // 2:] = 0
        return images, total
    monkeypatch.setattr(multiview, "_render_view_batch", half)


@pytest.mark.parametrize("cell,fault", [
    ("igor6k.frames1024", stale_frames),
    ("igor6k.frames1024", half_frame),
    ("trex14k.frames1024", altered_frame),
    ("igor6k.turntable64_vb8", stale_sweep),
    ("trex14k.turntable64_vb8", half_batch),
    ("igor6k.turntable64_vb8", altered_frame),
], ids=lambda x: getattr(x, "__name__", x))
def test_fault_is_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch)
    result = small_run(cell)
    assert not result["correct"], result["checks"]
