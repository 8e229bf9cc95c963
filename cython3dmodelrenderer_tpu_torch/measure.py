"""Measurement helpers shared by ``chip_smoke.py``, the probes and the
profiling tool: the card's data-sheet peaks and the roofline bound,
CUDA-event timing, device time and device operations under
``torch.profiler``, and nvidia-smi's reading of the card.
"""
from __future__ import annotations

import statistics
import subprocess

#: H100 SXM device-memory rate, bytes/s (data sheet)
HBM_BYTES_PER_S = 3.35e12
#: f32 instructions/s outside the tensor cores: 132 SMs x 128 lanes x the
#: 1.98 GHz boost clock. The data sheet's 67 TFLOP/s counts an FMA as two
#: operations; the port's kernels build with -fmad=false, so each multiply,
#: add, compare and select is one instruction at this rate.
F32_INSTR_PER_S = 33.5e12


def roofline_ms(bytes_moved: float, ops: float):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over the instruction rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_INSTR_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_time_ms(fn, n: int, warmup: int = 5) -> float:
    """Median ms of ``n`` calls of ``fn`` after ``warmup`` calls, each
    timed with CUDA events on the current stream."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_us(event) -> float:
    """Device time of a profiler entry (the attribute's name changed
    across PyTorch versions)."""
    for attr in ("device_time_total", "cuda_time_total"):
        value = getattr(event, attr, None)
        if value:
            return value
    return 0.0


def device_entries(prof) -> list:
    """The profiler's device entries (kernels, memsets, copies) that took
    device time, one per name."""
    return [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and device_us(e) > 0]


def profile_calls(fn, n: int, warmup: int = 5):
    """(device ms, device operations) per call of ``fn`` over ``n`` calls
    under ``torch.profiler``; (None, None) when it sees no device work."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    entries = device_entries(prof)
    if not entries:
        return None, None
    return (sum(device_us(e) for e in entries) / n / 1e3,
            sum(e.count for e in entries) / n)


def smi(fields: str) -> str:
    """``nvidia-smi --query-gpu=<fields> --format=csv,noheader`` for card 0."""
    out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]
