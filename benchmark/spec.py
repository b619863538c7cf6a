"""The benchmark's description, found by name.

``BENCHMARK.json`` at the checkout's root names the cells; each name leads
to files of its own under ``benchmark/``:

- a configuration: the ``file`` its entry names (``configs/<name>.json``);
- a traffic mix: ``traffic/<name>.json``, whose ``kind`` names the driver
  ``kinds/<kind>.py`` that runs it;
- a cell's correctness limits: ``limits/<workload>.json``;
- a per-layer metric: its reader ``metrics/<name>.py``.

Adding a cell takes new files and a new ``workloads`` entry, and no edit.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


@dataclass
class Cell:
    workload: dict
    config: dict        # the configuration's file: source, config, ...
    traffic: dict
    limits: dict
    end_to_end: list    # metric entries this cell reports
    per_layer: list

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    bench = load_benchmark(root)
    found = [w for w in bench["workloads"] if w["name"] == workload]
    if not found:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; known: "
                       f"{[w['name'] for w in bench['workloads']]}")
    w = found[0]
    cfg = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    return Cell(
        workload=w, config=_read(root / cfg["file"]),
        traffic=_read(root / "benchmark" / "traffic" / f"{w['traffic']}.json"),
        limits=_read(root / "benchmark" / "limits" / f"{workload}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)])


def kind(name: str):
    """The driver module of a traffic kind."""
    return importlib.import_module(f"benchmark.kinds.{name}")


def reader(metric: str, root: Path = ROOT):
    """The ``read(records) -> float | None`` of a per-layer metric."""
    path = root / "benchmark" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
