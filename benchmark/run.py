"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the checkout's root, on a machine with as many CUDA cards as the cell
asks for; without them it exits with an error and prints no result. The
run loads the program, makes the weights and inputs from the seed, warms
up the cell's shapes (set-up, ``setup_s``), measures for ``--seconds``,
then frees the program and checks what the timed path produced against the
plain reference (``correct``). With ``--trace 0`` the metrics are the
cell's end-to-end metrics; with ``--trace 1`` the window runs under the
profiler and the metrics are the cell's per-layer metrics, read from the
trace, the spans and the counters by the readers in ``metrics/``.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``check``, each compared number with its limit.
The same numbers end standard error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402

from benchmark import spec  # noqa: E402
from benchmark.compare import judge  # noqa: E402
from benchmark.trace import Trace, port_kernel_names  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "motionbert_tpu")
CSRC = spec.ROOT / "motionbert_tpu_torch" / "ops" / "csrc"


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the run must not load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def per_layer(cell: spec.Cell, records: dict) -> dict:
    out = {}
    for m in cell.per_layer:
        value = spec.reader(m["name"])(records)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool, device,
        faults=()) -> dict:
    """Set up, measure and check one run of ``cell`` on ``device``; the
    result object without ``device``. ``faults`` break the timed path
    underneath (the harness's own tests)."""
    import torch

    kind = spec.kind(cell.traffic["kind"])
    trace = Trace(traced, port_kernel_names(CSRC), kind.REGIONS)
    c = kind.Cell(cell, seed, device, trace, faults=faults)
    c.setup()
    setup_s = time.perf_counter() - T_START
    at, phases = T_START, []
    for label, t in c.marks:
        phases.append(f"{label} {t - at:.3f}")
        at = t
    print("setup phases s: " + ", ".join(phases), file=sys.stderr)
    c.measure(seconds)
    attempted, failed = c.counts()
    extra = {}
    if device.type == "cuda":
        extra["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(
            device))
    if traced:
        records = dict(trace.records(), **c.records())
        metrics = per_layer(cell, records)
        extra.update(busy_s=records["busy_s"], window_s=records["window_s"])
        breakdown = {"device_ops": records["device_ops"],
                     "idle_gaps": records["idle_gaps"]}
    else:
        values = dict(c.end_to_end(), setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
        breakdown = None
    late = c.lateness_ms() if hasattr(c, "lateness_ms") else None
    readings = c.readings()
    ok, rows = judge(readings, cell.limits["limits"])
    result = {"correct": bool(ok and failed == 0), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": extra}
    if breakdown is not None:
        result["breakdown"] = breakdown
    if late is not None:
        result["generator_late_ms"] = late
    result["check"] = {name: {"value": value, "limit": limit}
                       for name, value, limit in rows}
    result["_readings"] = readings
    return result


def _json_safe(x):
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    if isinstance(x, dict):
        return {k: _json_safe(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_json_safe(v) for v in x]
    return x


def main(argv=None) -> int:
    args = parse_args(argv)
    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"error: {args.workload} needs {cell.chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    result = run(cell, args.seed, args.seconds, bool(args.trace), device)
    readings = result.pop("_readings")
    bad = forbidden_modules()
    if bad:
        print(f"error: the run loaded {bad}", file=sys.stderr)
        return 3
    result["device"] = dict(
        platform="gpu", kind=torch.cuda.get_device_name(device),
        count=cell.chips, **result["device"])
    late = result.get("generator_late_ms")
    if late is not None:
        print(f"generator lateness ms: p50 {late['p50']:.4f} p99 "
              f"{late['p99']:.4f} max {late['max']:.4f}", file=sys.stderr)
    for key, value in readings.items():
        if key.startswith("_"):
            print(f"{key[1:]}: {value}", file=sys.stderr)
        elif key not in result["check"]:
            print(f"read, not compared: {key} {value!r}", file=sys.stderr)
    for name, row in result["check"].items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_json_safe(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
