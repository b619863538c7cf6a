"""The harness on the CPU: its description resolves by name, its inputs
come from the seed, its statistics cover every request and the whole
window, its trace reduction reads the profiler's format, and it refuses to
run where it must not."""

import json
import math
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

from benchmark import inputs, spec
from benchmark.kinds import serve_open, train_closed
from benchmark.trace import (NO_REGION, SHORT_GAPS, kernel_base,
                             port_kernel_names, reduce_events)

ROOT = spec.ROOT
BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_json_keeps_to_its_schema():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += WORKLOADS + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]
        assert c["file"].startswith("benchmark/") and c["reduced"] == []
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and w["chips"] == 1


@pytest.mark.parametrize("workload", WORKLOADS)
def test_every_cell_resolves_by_name(workload):
    cell = spec.load_cell(workload)
    kind = spec.kind(cell.traffic["kind"])
    assert kind.KIND in ("train", "serve") and hasattr(kind, "Cell")
    assert cell.limits["limits"]
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
        assert spec.reader(m["name"])({}) is None     # nothing to read


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_is_its_yaml(config):
    cfg = json.loads((ROOT / config["file"]).read_text())
    assert cfg["source"] == config["source"]
    assert cfg["config"] == yaml.safe_load((ROOT / cfg["yaml"]).read_text())


def test_a_new_cell_takes_only_new_files(tmp_path):
    (tmp_path / "benchmark").mkdir()
    for d in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(ROOT / "benchmark" / d, tmp_path / "benchmark" / d)
    bench = json.loads(json.dumps(BENCH))
    traffic = json.loads((ROOT / "benchmark" / "traffic" /
                          "poisson_lite.json").read_text())
    traffic["rate_per_s"] = 123.0
    (tmp_path / "benchmark" / "traffic" / "poisson_slow.json").write_text(
        json.dumps(traffic))
    shutil.copy(ROOT / "benchmark" / "limits" /
                "serve.motionbert_lite.poisson.json",
                tmp_path / "benchmark" / "limits" / "serve.motionbert.slow.json")
    bench["workloads"].append({"name": "serve.motionbert.slow",
                               "config": "motionbert", "traffic":
                               "poisson_slow", "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("serve.motionbert.slow", root=tmp_path)
    assert cell.traffic["rate_per_s"] == 123.0
    assert cell.config["config"]["dim_feat"] == 512
    # metrics without a workloads key reach every cell; keyed ones do not
    assert {m["name"] for m in cell.end_to_end} == {"setup_s"}
    assert spec.kind(cell.traffic["kind"]) is serve_open


def test_streams_and_clips_come_from_the_seed():
    big = 2 ** 33 + 7
    assert inputs.streams(big) == inputs.streams(big)
    assert inputs.streams(big) != inputs.streams(big + 1)
    a = inputs.clip_pool(11, 4, 27)
    b = inputs.clip_pool(11, 4, 27)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert a[0].shape == (4, 27, 17, 3) and a[0].dtype == np.float32
    assert (a[0][..., 2] >= 0.5).all() and (a[0][..., 2] <= 1).all()


def test_poisson_schedule_is_reproducible_with_a_fixed_count():
    t1, c1 = inputs.poisson_schedule(5, 400.0, 10.0, 64)
    t2, c2 = inputs.poisson_schedule(5, 400.0, 10.0, 64)
    t3, _ = inputs.poisson_schedule(6, 400.0, 10.0, 64)
    assert np.array_equal(t1, t2) and np.array_equal(c1, c2)
    assert len(t1) == len(t3) == 4000
    assert not np.array_equal(t1, t3)
    assert (np.diff(t1) >= 0).all() and 0 <= t1[0] and t1[-1] < 10.0
    gaps = np.diff(t1)   # exponential: mean 1/rate, sd about the mean
    assert gaps.mean() == pytest.approx(1 / 400, rel=0.05)
    assert gaps.std() == pytest.approx(1 / 400, rel=0.1)


def test_batches_use_every_row_before_repeating():
    order = inputs.batch_order(3, 10, 4)
    first = [next(order) for _ in range(2)]
    assert len(set(np.concatenate(first))) == 8


def test_percentile_takes_every_request_and_missing_ones_count():
    v = list(range(1, 101))
    assert inputs.percentile(v, 50) == 50 and inputs.percentile(v, 95) == 95
    assert inputs.percentile(v[:-5] + [math.inf] * 5, 95) == 95
    assert inputs.percentile(v[:-6] + [math.inf] * 6, 95) == math.inf


def test_serving_latency_is_from_the_schedule_over_every_request():
    c = serve_open.Cell.__new__(serve_open.Cell)
    c.t0 = 100.0
    c.arrive = np.arange(20) * 0.01
    c.done = c.t0 + c.arrive + 0.002           # 2 ms each
    c.done[3] = np.nan                          # never completed
    c.done[7] = c.t0 + c.arrive[7] + 0.5
    lat = c.latencies_ms()
    assert lat[3] == math.inf and lat[7] == pytest.approx(500)
    e2e = c.end_to_end()
    assert e2e["lift_p50_ms"] == pytest.approx(2)
    assert e2e["lift_p95_ms"] == pytest.approx(500)  # 19th of 20
    assert c.counts() == (20, 1)


def test_training_rate_is_over_the_whole_window():
    c = train_closed.Cell.__new__(train_closed.Cell)
    c.steps, c.B, c.window_s = 41, 32, 10.25
    assert c.end_to_end()["train_clips_per_s"] == pytest.approx(128.0)


def test_one_leaf_moves_the_worst_gradient_gap_and_not_the_median():
    import torch
    from benchmark.compare import train_readings

    names = ["a", "b", "c", "gate"]
    grad1 = [torch.full((4,), 1.0), torch.full((4,), 2.0),
             torch.full((4,), 3.0), torch.full((2,), 8.0)]
    reference = {"names": names, "grad1": grad1, "loss": [1.0],
                 "delta": [g.clone() for g in grad1]}
    program = {"loss": [1.0], "delta": {n: g.clone() for n, g in
                                        zip(names, grad1)},
               "grad_norm": {n: float(g.norm()) * (1.1 if n == "gate"
                                                   else 1.0001)
                             for n, g in zip(names, grad1)}}
    r = train_readings(program, reference)
    assert r["grad_norm_gap"] == pytest.approx(0.1, rel=1e-4)
    # a and b are measured against the median norm (5): 0.4e-4, 0.8e-4
    assert r["grad_norm_gap_median"] == pytest.approx(0.9e-4, rel=1e-2)
    assert r["_grad_top"][0][0] == "gate" and r["update_norm_gap"] == 0


def test_kernel_names():
    names = port_kernel_names(ROOT / "motionbert_tpu_torch" / "ops" / "csrc")
    assert {"hg_gemm_kernel", "attn_tc_fwd_kernel", "gate_kernel",
            "ln_bwd_fused_kernel"} <= names
    assert kernel_base("void (anonymous namespace)::hg_gemm_kernel<0, 1, "
                       "(anonymous namespace)::HgEpi<2> >(Params, int)") \
        == "hg_gemm_kernel"
    assert kernel_base("attn_tc_fwd_kernel<64, 16>") == "attn_tc_fwd_kernel"
    assert kernel_base("void at::native::vectorized_elementwise_kernel<4, "
                       "at::native::FillFunctor<float> >(int, ...)") == \
        "vectorized_elementwise_kernel"


def _ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_trace_reduction():
    ev = [_ev("user_annotation", "bench.window", 0, 1000),
          _ev("user_annotation", "bench.step", 0, 600),
          _ev("user_annotation", "Optimizer.step#AdamW.step", 400, 150),
          _ev("cuda_runtime", "cudaLaunchKernel", 10, 5, corr=1),
          _ev("cuda_runtime", "cudaLaunchKernel", 20, 5, corr=2),
          _ev("cuda_runtime", "cudaLaunchKernel", 410, 5, corr=3),
          _ev("cpu_op", "aten::copy_", 700, 100, tid=1),
          _ev("cuda_runtime", "cudaMemcpyAsync", 790, 5, corr=4),
          _ev("kernel", "void hg_gemm_kernel<0>(P)", 100, 200, corr=1),
          _ev("kernel", "gate_kernel", 250, 100, corr=2),     # overlaps
          _ev("kernel", "void at::native::foo<1>()", 420, 50, corr=3),
          _ev("gpu_memcpy", "Memcpy HtoD", 810, 10, corr=4),
          _ev("kernel", "outside", 1200, 10, corr=9)]
    r = reduce_events(ev, frozenset({"hg_gemm_kernel", "gate_kernel"}),
                      regions=("Optimizer.step#",))
    assert r["window_s"] == pytest.approx(1000e-6)
    assert r["busy_s"] == pytest.approx((250 + 50 + 10) * 1e-6)
    assert r["port_kernel_s"] == pytest.approx(300e-6)
    assert r["region_device_s"]["Optimizer.step#"] == pytest.approx(50e-6)
    idle = dict(r["idle_gaps"])
    # each gap is named by what the thread that launched the next device
    # work was doing when the gap began: 0-100 and 350-420 the step,
    # 470-810 AdamW's region, 820-1000 (no later work: the window's thread)
    # nothing
    assert idle["bench.step"] == pytest.approx((100 + 70) * 1e-6)
    assert idle["Optimizer.step#AdamW.step"] == pytest.approx(340e-6)
    assert idle[NO_REGION] == pytest.approx(180e-6)
    assert SHORT_GAPS not in idle
    assert r["device_ops"][0] == ["void hg_gemm_kernel<0>(P)",
                                  pytest.approx(200e-6)]


def test_trace_needs_its_window():
    with pytest.raises(ValueError):
        reduce_events([_ev("kernel", "k", 0, 1)], frozenset())


def _run_cli(cwd, code):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_the_run_fails_without_a_card():
    out = _run_cli(ROOT, "import sys; from benchmark import run; "
                         "sys.exit(run.main(['--workload', "
                         "'train.motionbert.b32', '--seed', '1', "
                         "'--seconds', '1', '--trace', '0']))")
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_the_run_fails_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, torch\n"
            "torch.cuda.is_available = lambda: True\n"
            "torch.cuda.device_count = lambda: 1\n"
            "from benchmark import run\n"
            "sys.exit(run.main(['--workload', 'serve.motionbert_lite.poisson',"
            " '--seed', '1', '--seconds', '1', '--trace', '0']))\n")
    out = _run_cli(tmp_path, code)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "motionbert_tpu_torch" in out.stderr
