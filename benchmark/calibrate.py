"""Readings that a cell's correctness limits are set from: the numbers
compared, for the program and for its control, on many seeds in one
process.

    python3 -m benchmark.calibrate --workload train.motionbert.b32 \\
        --seeds 1,2,3 [--attn_impl kernel_q8] [--faults half_batch] \\
        [--seconds 3]

Each seed builds the cell anew, runs its set-up (a training cell's first
steps are what is compared, so it needs no window) and, for a serving
cell, a short window at the cell's own rate, then frees the program and
runs the plain reference. ``--attn_impl kernel_q8`` is a serving cell's
control: the program's own W8A8 path, a precision below the
configuration's bf16.
``--fp8_reference 1`` is a training cell's control: the reference with
its products in float8 in the program's place. ``--faults`` plants a
fault in the timed path (see the kinds). One JSON line per seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from benchmark import spec
from benchmark.trace import Trace


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--attn_impl", default="kernel")
    p.add_argument("--fp8_reference", type=int, choices=(0, 1), default=0,
                   help="a training cell's control: the reference in float8 "
                        "in the program's place")
    p.add_argument("--faults", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("error: calibration needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    kind = spec.kind(cell.traffic["kind"])
    faults = tuple(f for f in args.faults.split(",") if f)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        c = kind.Cell(cell, seed, torch.device("cuda", 0), Trace(False, ()),
                      faults=faults, attn_impl=args.attn_impl)
        if args.fp8_reference:
            readings = c.control_readings()
        else:
            c.setup()
            if kind.KIND == "serve":
                c.measure(args.seconds)
            readings = c.readings()
        print(json.dumps(dict(seed=seed, attn_impl=args.attn_impl,
                              fp8_reference=args.fp8_reference,
                              faults=list(faults), seconds=round(
                                  time.perf_counter() - t, 3),
                              **readings)), flush=True)
        del c
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
