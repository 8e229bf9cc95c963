"""The benchmark of cython3dmodelrenderer_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with an NVIDIA GPU. It
builds the cell's inputs from the seed, warms up, measures for
``--seconds``, compares what the timed path produced with the plain
reference, and prints one JSON line as the last line of its output: the
end-to-end metrics with ``--trace 0``, the per-layer metrics (read from a
traced window) with ``--trace 1``. Without a card it exits with 2.
"""
import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# one process, few host threads; every cache inside the checkout
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(var, "1")
for var, sub in (("CUDA_CACHE_PATH", "nv"), ("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)
sys.path[:0] = [str(HERE), str(ROOT)]

import torch  # noqa: E402

import harness  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    bench = harness.read_json(ROOT / "BENCHMARK.json")
    cell = harness.Cell(args.workload, bench)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), started=STARTED, device="cuda:0")
    found = harness.forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        print(f"check {name}: {check['value']} (limit {check['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
