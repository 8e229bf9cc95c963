"""Readings of the control, for the limits of ``correct``.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 [--seconds 5]

The control is the plain reference, computed in bfloat16 (the precision
below the float32 the configurations state), put in the program's place:
each seed runs the cell at its own size with a short window and prints
one JSON line with the numbers compared (``checks``). All seeds run in
one process. The benchmark's own runs never run this. Needs the card, as
run.py does.
"""
import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import run  # noqa: E402,F401  (sets the environment and the import path)
import torch  # noqa: E402

import harness  # noqa: E402

CONTROL = torch.bfloat16


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=5.0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("control.py needs a CUDA device", file=sys.stderr)
        return 2
    started = STARTED
    for seed in (int(s) for s in args.seeds.split(",")):
        result = harness.run(args.workload, seed, args.seconds, False,
                             started=started, device="cuda:0", control=CONTROL)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": str(CONTROL),
                          "attempted": result["attempted"],
                          "correct": result["correct"],
                          "checks": result["checks"]}), flush=True)
        started = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
