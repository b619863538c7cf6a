"""Find a serving cell's knee: its traffic at a list of offered rates, one
window each, in one process on one card.

    python3 -m benchmark.sweep --workload serve.motionbert_lite.poisson \\
        --rates 200,300,400 --seconds 10 --seed 1 [--trace 1]

Prints one JSON line per rate: p50 and p95 latency over every request due
in the window, the requests still open when it closed, the completions
against the arrivals in its last quarter, the generator's lateness and,
with ``--trace 1``, the device's idle share. The knee is the highest rate
at which the backlog does not grow: the last quarter's completions keep
pace with its arrivals and few requests are open at the close. A cell's
traffic file then fixes its rate at four fifths of the knee.
"""

from __future__ import annotations

import argparse
import json
import sys

from benchmark import spec
from benchmark.trace import Trace, port_kernel_names


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("error: the sweep needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    kind = spec.kind(cell.traffic["kind"])
    names = port_kernel_names(spec.ROOT / "motionbert_tpu_torch" / "ops"
                              / "csrc")
    c = kind.Cell(cell, args.seed, torch.device("cuda", 0),
                  Trace(False, names))
    c.setup()
    for rate in (float(r) for r in args.rates.split(",")):
        c.rate = rate
        c.trace = c.lifter.trace = Trace(bool(args.trace), names)
        c.measure(args.seconds)
        row = dict(rate_per_s=rate, **c.end_to_end(), **c.backlog(),
                   attempted=c.counts()[0], failed=c.counts()[1],
                   late_ms=c.lateness_ms())
        if args.trace:
            rec = c.trace.records()
            row["device_idle_pct"] = 100.0 * (1 - rec["busy_s"]
                                              / rec["window_s"])
        rec = c.records()
        row["avg_batch"] = rec["real_rows"] / max(rec["batches"], 1)
        print(json.dumps(row), flush=True)
    c.server.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
