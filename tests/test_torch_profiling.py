"""The port's ``core/profiling.py`` (on ``torch.profiler``) against the JAX
package's ``motionbert_tpu/core/profiling.py`` (on ``jax.profiler``), run on
the same sequence of calls: the region and step summaries have the same keys
and counts; a trace into a directory is a Chrome trace holding an annotated
region's name; with no directory and no ``MOTIONBERT_PROFILE_DIR`` nothing
is written."""

import json
import os

import numpy as np
import pytest
import torch

from motionbert_tpu.core import profiling as jprof
from motionbert_tpu_torch.core import profiling as tprof


def _regions(mod, names):
    mod.REGIONS.total.clear()
    mod.REGIONS.count.clear()
    for name in names:
        with mod.annotate(name):
            pass
    return mod.REGIONS.summary()


@pytest.mark.parametrize("names", [("fwd",), ("fwd", "bwd", "fwd", "opt"),
                                   ("a", "a", "a")])
def test_regions_summary_matches_jax(names):
    got, want = _regions(tprof, names), _regions(jprof, names)
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].keys() == want[name].keys()
        assert got[name]["count"] == want[name]["count"] == names.count(name)
        assert got[name]["total_s"] >= 0.0


def test_region_counts_even_when_nested():
    tprof.REGIONS.total.clear()
    tprof.REGIONS.count.clear()
    with tprof.annotate("outer"):
        with tprof.annotate("inner"):
            pass
    assert {k: v["count"] for k, v in tprof.REGIONS.summary().items()} == \
        {"outer": 1, "inner": 1}


@pytest.mark.parametrize("steps", [0, 1, 3])
def test_step_timer_summary_matches_jax(steps):
    got, want = tprof.StepTimer(), jprof.StepTimer()
    for timer in (got, want):
        for _ in range(steps):
            timer.data_ready()
            timer.step_done()
    a, b = got.summary(), want.summary()
    assert a.keys() == b.keys() == {"steps", "data_ms", "step_ms"}
    assert a["steps"] == b["steps"] == steps
    assert all(np.isfinite(a[k]) and a[k] >= 0 for k in a)


def test_trace_writes_a_chrome_trace_with_the_regions(tmp_path):
    x = torch.ones(64, 64)
    with tprof.trace(str(tmp_path)):
        with tprof.annotate("tp_region_under_trace"):
            (x @ x).sum()
    files = os.listdir(tmp_path)
    assert files == ["trace.rank0.json"]
    events = json.loads((tmp_path / files[0]).read_text())["traceEvents"]
    assert any(e.get("name") == "tp_region_under_trace" for e in events)


def test_trace_reads_the_environment(tmp_path, monkeypatch):
    monkeypatch.setenv("MOTIONBERT_PROFILE_DIR", str(tmp_path / "env"))
    with tprof.trace():
        torch.ones(4).sum()
    assert os.listdir(tmp_path / "env") == ["trace.rank0.json"]


def test_trace_without_a_directory_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.delenv("MOTIONBERT_PROFILE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    for mod in (tprof, jprof):
        with mod.trace():
            torch.ones(4).sum()
    assert os.listdir(tmp_path) == []
