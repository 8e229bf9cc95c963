"""Profile steady-state frames of the PyTorch port on a CUDA GPU.

Run from the repository root on a machine with an NVIDIA GPU:

    python tools/profile_torch_frame.py [--scene sphere16k|torus262k]
        [--size 1024] [--frames 20] [--out DIR] [--sweep 1,2,4,8] [--b5]
        [--binning]

Renders a scene of ``chip_smoke.py`` (the 16,128-triangle displaced UV
sphere, or the 262,144-triangle displaced torus) at ``--size``² with
GuroIllumination and NoIllumination through ``Renderer.render``, traces
``--frames`` warm frames with ``torch.profiler``, and prints per frame:
wall time, summed device-kernel time (and so the device's idle share),
the number of kernel launches, and the kernels ranked by device time.
``--sweep`` traces instead ``--frames`` sweeps of ``chip_smoke.py``'s
8-view turntable through ``Renderer.render_sequence`` at each listed
view_batch (numbers per view); ``--b5`` traces ``--frames`` calls of
B5's wrapper on the scene's spans (group 16, sub 8, ample slot_cap);
``--binning`` traces ``--frames`` calls of each binning route on the
scene's lambert_u8 spans (``binsort.bin_sort``, and ``binsort.bin_pairs``
where the pair key fits in 31 bits): device operations and device ms a
call.
The chrome traces go to ``--out`` (default ``build/profile``).
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke  # noqa: E402
import cython3dmodelrenderer_tpu_torch as pt  # noqa: E402
from cython3dmodelrenderer_tpu_torch.measure import (  # noqa: E402
    device_entries, device_us, smi)


def trace(label, fn, reps, per, out):
    """Profile ``reps`` warm calls of ``fn``; print per-``per`` numbers."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / (reps * per) * 1e3
    prof.export_chrome_trace(os.path.join(out, f"{label.replace('/', '_')}.json"))
    kernels = device_entries(prof)
    n = reps * per
    dev = sum(device_us(e) for e in kernels) / n / 1e3
    top = sorted(kernels, key=lambda e: -device_us(e))[:12]
    print(json.dumps({
        "frame": label, "wall_ms": wall, "device_ms": dev,
        "device_idle_share": 1.0 - dev / wall if wall else None,
        "kernel_launches": sum(e.count for e in kernels) / n,
        "top": [{"kernel": e.key[:80], "ms": device_us(e) / n / 1e3,
                 "calls": e.count / n} for e in top]}))
    print(prof.key_averages().table(sort_by="self_cpu_time_total",
                                    row_limit=15))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", choices=("sphere16k", "torus262k"),
                    default="sphere16k")
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "profile"))
    ap.add_argument("--sweep", default="",
                    help="comma-separated view_batch values to trace")
    ap.add_argument("--b5", action="store_true")
    ap.add_argument("--binning", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    os.makedirs(args.out, exist_ok=True)
    if args.scene == "sphere16k":
        v, f = chip_smoke.displaced_sphere(chip_smoke.TRI_SPHERE_SEGMENTS,
                                           chip_smoke.TRI_SPHERE_RINGS)
    else:
        v, f = chip_smoke.displaced_torus(*chip_smoke.TORUS_QUADS)
    model = chip_smoke.posed(pt.Model(v, f, device="cuda"), True)
    print(smi("name,power.limit"))
    tag = f"{args.scene}@{args.size}"
    if args.binning:
        from cython3dmodelrenderer_tpu_torch.ops import binsort

        spans = chip_smoke.frame_setup(model, "lambert_u8", args.size)[1]
        trace(f"bin_sort_{tag}", lambda: binsort.bin_sort(*spans),
              args.frames, 1, args.out)
        tx0, ntx, nty = spans[0], spans[4], spans[5]
        if (tx0.shape[0] - 1).bit_length() + (ntx * nty - 1).bit_length() <= 31:
            trace(f"bin_pairs_{tag}", lambda: binsort.bin_pairs(*spans),
                  args.frames, 1, args.out)
        return
    if args.b5:
        from cython3dmodelrenderer_tpu_torch.ops import binsort_grouped as bg

        chip_smoke.SIZE = args.size
        spans = chip_smoke.frame_setup(model, "lambert_u8", args.size)[1][:6]
        cap = int(bg.bin_sort_grouped_plain(*spans, 1 << 16, 16, 8)[6])
        trace(f"b5_{tag}", lambda: bg.bin_sort_grouped(*spans, cap, 16, 8),
              args.frames, 1, args.out)
        return
    for name, illum in (("guro", pt.GuroIllumination([0, 0, 1])),
                        ("none", pt.NoIllumination())):
        renderer = pt.Renderer(
            pt.AdvancedPixelBufferFiller(args.size, args.size, fov=45,
                                         device="cuda"),
            illum, pt.SimpleIterator, args.size, args.size)
        if not args.sweep:
            trace(f"frame_{tag}/{name}", lambda: renderer.render(model),
                  args.frames, 1, args.out)
            continue
        centred = chip_smoke.turntable_model("cuda")
        for vb in (int(x) for x in args.sweep.split(",")):
            sweep = chip_smoke.sweep_args(renderer, centred, vb)
            trace(f"sweep_{tag}/{name}/vb{vb}",
                  lambda: renderer.render_sequence(**sweep), args.frames,
                  chip_smoke.SWEEP_VIEWS, args.out)


if __name__ == "__main__":
    main()
