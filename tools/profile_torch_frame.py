"""Profile one steady-state 1024² frame of the PyTorch port on a CUDA GPU.

Run from the repository root on a machine with an NVIDIA GPU:

    python tools/profile_torch_frame.py [--frames 20] [--out DIR]

Renders the 16,128-triangle displaced UV sphere of ``chip_smoke.py`` with
GuroIllumination and NoIllumination through ``Renderer.render``, traces
``--frames`` warm frames with ``torch.profiler``, and prints per frame:
wall time, summed device-kernel time (and so the device's idle share),
the number of kernel launches, and the kernels ranked by device time.
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


def device_us(event) -> float:
    """Device time of a profiler entry (the attribute's name changed
    across PyTorch versions)."""
    for attr in ("device_time_total", "cuda_time_total"):
        value = getattr(event, attr, None)
        if value:
            return value
    return 0.0


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "profile"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    os.makedirs(args.out, exist_ok=True)
    v, f = chip_smoke.displaced_sphere(chip_smoke.TRI_SPHERE_SEGMENTS,
                                       chip_smoke.TRI_SPHERE_RINGS)
    model = chip_smoke.posed(pt.Model(v, f, device="cuda"), True)
    print(chip_smoke.smi_line())
    for name, illum in (("guro", pt.GuroIllumination([0, 0, 1])),
                        ("none", pt.NoIllumination())):
        renderer = pt.Renderer(
            pt.AdvancedPixelBufferFiller(1024, 1024, fov=45, device="cuda"),
            illum, pt.SimpleIterator, 1024, 1024)
        for _ in range(10):
            renderer.render(model)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.frames):
                renderer.render(model)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / args.frames * 1e3
        prof.export_chrome_trace(os.path.join(args.out, f"frame_{name}.json"))
        kernels = [e for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA") and device_us(e) > 0]
        dev = sum(device_us(e) for e in kernels) / args.frames / 1e3
        launches = sum(e.count for e in kernels) / args.frames
        top = sorted(kernels, key=lambda e: -device_us(e))[:12]
        print(json.dumps({
            "frame": name, "wall_ms": wall, "device_ms": dev,
            "device_idle_share": 1.0 - dev / wall if wall else None,
            "kernel_launches": launches,
            "top": [{"kernel": e.key[:80], "ms": device_us(e)
                     / args.frames / 1e3, "calls": e.count / args.frames}
                    for e in top]}))
        print(prof.key_averages().table(sort_by="self_cpu_time_total",
                                        row_limit=15))


if __name__ == "__main__":
    main()
