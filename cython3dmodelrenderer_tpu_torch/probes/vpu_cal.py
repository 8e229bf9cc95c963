"""Calibrate the card's achieved f32 instruction rate — kernel P2 and its
plain version.

``run_once`` replaces the TPU kernel of ``tools/probes/vpu_cal.py``
(``make.kernel``, launched by ``make.run_once``, ``vpu_cal.py:51``): a
chain of multiply-add and compare-select over a (GRID, 16, 32, 128) f32
input, the grid walked in order, the (16, 32, 128) accumulator after the
last step returned. On a CUDA tensor it launches ``csrc/vpu_cal.cu`` (one
thread per element, looping over the steps; see the source); on a CPU
tensor it runs ``run_once_plain``. ``run`` chains ``NITER`` runs through
``out[0, 0, 0]`` as the JAX probe's ``run`` does.

On the card (fails without one)::

    python -m cython3dmodelrenderer_tpu_torch.probes.vpu_cal

prints the time per launch at each ``N_OPS`` (CUDA events), the slope in
ns per element-step-op, and the achieved f32 instruction rate beside the
33.5 T instructions/s peak, with the clocks and power limit nvidia-smi
reads.
"""
from __future__ import annotations

import ctypes
import sys

import torch

from .. import cuda_build
from ..device import resolve_backend, resolve_device
from ..measure import F32_INSTR_PER_S, cuda_time_ms, smi
from ..ops.raster import INSTR_PER_BBOX_PIXEL
from ..utils import timing

TH, TW, K = 16, 32, 128
GRID = 64                                  # grid steps a run walks
NITER = 10                                 # chained runs of ``run``
N_OPS = (8, 32, 128, 512)                  # chain lengths the kernel has
#: instructions per op: under -fmad=false a mul-add + compare-select pair
#: is FMUL, FADD, FSETP and a predicated FADD (the select folds into the
#: predicate; cuobjdump of the n_ops = 512 kernel: 257 FMUL, 513 FADD, 256
#: FSETP, no FSEL) — 4 per 2 ops
INSTR_PER_OP = 2.0


def make_input(grid: int = GRID, device=None) -> torch.Tensor:
    """The probe's input: ``linspace(0.5, 1.5)`` over (grid, 16, 32, 128)
    f32, on ``device`` (the card by default)."""
    n = grid * TH * TW * K
    return torch.linspace(0.5, 1.5, n, dtype=torch.float32,
                          device=resolve_device(device)).reshape(grid, TH,
                                                                 TW, K)


def _check(x: torch.Tensor, n_ops: int) -> None:
    if x.dtype != torch.float32 or x.dim() != 4 or not x.is_contiguous():
        raise ValueError("vpu_cal takes a contiguous (grid, 16, 32, 128) "
                         f"float32 tensor, got {x.dtype} {tuple(x.shape)}")
    if n_ops not in N_OPS:
        raise ValueError(f"n_ops must be one of {N_OPS}, got {n_ops}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"vpu_cal: unsupported device {x.device}")


def run_once_plain(x: torch.Tensor, n_ops: int) -> torch.Tensor:
    """The plain version: the same chain, one torch op at a time."""
    _check(x, n_ops)
    tiny = torch.tensor(1e-30, dtype=torch.float32, device=x.device)
    acc = torch.zeros(x.shape[1:], dtype=torch.float32, device=x.device)
    for i in range(x.shape[0]):
        xi = x[i]
        acc = xi + acc * tiny
        for j in range(n_ops // 2):
            acc = acc * xi + float(j)
            acc = torch.where(acc > xi, acc - xi, acc)
    return acc


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("vpu_cal")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.vpu_cal_launch.argtypes = [p, i, i, i, p, i, p]
    lib.vpu_cal_launch.restype = ctypes.c_int
    return lib


def run_once(x: torch.Tensor, n_ops: int,
             backend: str = "auto") -> torch.Tensor:
    """One run: (grid, 16, 32, 128) f32 → the (16, 32, 128) accumulator.

    ``backend="auto"`` launches kernel P2 on a CUDA tensor and runs
    ``run_once_plain`` on a CPU tensor; ``"cuda"`` raises for a CPU
    tensor; ``"torch"`` runs the plain version anywhere.
    """
    _check(x, n_ops)
    if resolve_backend(backend, x.device) == "torch":
        return run_once_plain(x, n_ops)
    grid, n = x.shape[0], TH * TW * K
    out = torch.empty(x.shape[1:], dtype=torch.float32, device=x.device)
    lib = _lib()
    err = lib.vpu_cal_launch(x.data_ptr(), grid, n, n_ops, out.data_ptr(),
                             x.device.index,
                             cuda_build.stream_handle(x.device))
    cuda_build.check(lib, err, "vpu_cal (csrc/vpu_cal.cu)")
    timing.counters["launch.vpu_cal"] += 1
    return out


def run(x: torch.Tensor, n_ops: int, backend: str = "auto") -> torch.Tensor:
    """``NITER`` chained runs, each on ``x + carry * 1e-30`` where carry
    is the previous run's ``out[0, 0, 0]`` (0 first); returns the last
    carry, a 0-dim f32 tensor."""
    tiny = torch.tensor(1e-30, dtype=torch.float32, device=x.device)
    carry = torch.zeros((), dtype=torch.float32, device=x.device)
    for _ in range(NITER):
        carry = run_once(x + carry * tiny, n_ops, backend)[0, 0, 0]
    return carry


def calibrate(x: torch.Tensor, n: int = 20) -> dict:
    """Median ms per launch at each ``N_OPS`` (CUDA events) and, from the
    two longest chains (fixed costs cancel), the slope in ns per
    element-step-op and the achieved instruction rate."""
    ms = {n_ops: cuda_time_ms(lambda: run_once(x, n_ops), n)
          for n_ops in N_OPS}
    (n1, t1), (n2, t2) = list(ms.items())[-2:]
    steps = x.shape[0] * TH * TW * K
    ns_per_op = (t2 - t1) * 1e6 / ((n2 - n1) * steps)
    rate = INSTR_PER_OP / (ns_per_op * 1e-9)
    return {"ms": ms, "ns_per_op": ns_per_op, "instr_per_s": rate}


def report(cal: dict) -> None:
    """Print the calibration as the JAX probe prints its own, in the card's
    terms."""
    for n_ops, ms in cal["ms"].items():
        print(f"n_ops={n_ops:4d}  {ms * 1e3:9.1f} us per launch", flush=True)
    rate = cal["instr_per_s"]
    print(f"per element-step-op: {cal['ns_per_op']:.4e} ns")
    print(f"f32 instructions/s ({INSTR_PER_OP} per op): {rate / 1e12:.2f} T "
          f"= {rate / F32_INSTR_PER_S:.3f} of the {F32_INSTR_PER_S / 1e12} T "
          "peak (132 SMs x 128 lanes x 1.98 GHz)")
    print("nvidia-smi clocks.sm, clocks.max.sm, power.limit: "
          + smi("clocks.sm,clocks.max.sm,power.limit"))
    print(f"=> B1 per (pair, pixel) in the pair's bbox ({INSTR_PER_BBOX_PIXEL}"
          f" instructions) at this rate: "
          f"{INSTR_PER_BBOX_PIXEL / rate * 1e12:.4f} ps", flush=True)


def main() -> int:
    x = make_input()                      # the card; raises without one
    print(f"{torch.cuda.get_device_name(0)} | nvidia-smi name, power.limit: "
          + smi("name,power.limit"), flush=True)
    report(calibrate(x))
    return 0


if __name__ == "__main__":
    sys.exit(main())
