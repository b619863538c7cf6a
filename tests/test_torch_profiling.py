"""The port's ``core/profiling.py``: spans and samples recorded only while a
torch profiler runs, where the work happens (the server's collector, the
lift, the train step, the feed), read by the benchmark's readers; and
``trace``, a Chrome trace into a directory with the spans beside it, which
with no directory and no ``MOTIONBERT_PROFILE_DIR`` writes nothing, as the
JAX package's ``motionbert_tpu/core/profiling.py`` does."""

import json
import math
import os
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import spec
from motionbert_tpu.core import profiling as jprof
from motionbert_tpu_torch.api import MotionBERT
from motionbert_tpu_torch.core import profiling as tprof
from motionbert_tpu_torch.core.config import ConfigDict
from motionbert_tpu_torch.data.datasets import device_prefetch
from motionbert_tpu_torch.models.factory import load_backbone
from motionbert_tpu_torch.serve import BatchingServer, MotionBERTServer
from motionbert_tpu_torch.train.pose3d import make_train_step
from motionbert_tpu_torch.train.state import make_adamw

TINY = ConfigDict(dim_feat=32, dim_rep=32, depth=1, num_heads=2, mlp_ratio=2,
                  num_joints=17, maxlen=9)
READERS = {"serve": ("serve_queue_wait_ms_p95", "serve_host_ms_per_batch",
                     "lift_device_ms_per_clip", "lift_graph_replay_pct"),
           "train": ("train_forward_ms_p50", "train_backward_ms_p50",
                     "train_feed_ms")}


@pytest.fixture(autouse=True)
def _empty_recorder():
    tprof.reset()
    yield
    tprof.reset()


def _profiler():
    return profile(activities=[ProfilerActivity.CPU])


def _named(items, name):
    return [x for x in items if x["name"] == name]


def _tiny_model():
    model = load_backbone(TINY, device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    return model


def _clips(n, seed=0):
    rs = np.random.RandomState(seed)
    return rs.uniform(-1, 1, (n, 9, 17, 3)).astype(np.float32)


# -- the gate -----------------------------------------------------------------

@pytest.mark.parametrize("device", [False, True])
def test_without_a_profiler_nothing_is_entered_or_recorded(device,
                                                           monkeypatch):
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name))
    assert not tprof.tracing()
    with tprof.annotate("off.outer", device=device, rows=3):
        with tprof.annotate("off.inner", device=device):
            tprof.observe("off.sample", 1.0)
    assert entered == []
    assert tprof.recorded() == {"spans": [], "device": [], "samples": []}


def test_nested_spans_keep_their_parents_and_land_in_the_chrome_trace(
        tmp_path):
    with _profiler() as prof:
        assert tprof.tracing()
        with tprof.annotate("tp.outer", rows=2):
            with tprof.annotate("tp.inner"):
                torch.ones(8).sum()
            with tprof.annotate("tp.second"):
                pass
    spans = {s["name"]: s for s in tprof.recorded()["spans"]}
    assert set(spans) == {"tp.outer", "tp.inner", "tp.second"}
    outer = spans["tp.outer"]
    assert outer["parent"] is None and outer["args"] == {"rows": 2}
    for name in ("tp.inner", "tp.second"):
        assert spans[name]["parent"] == outer["id"]
        assert outer["start_ns"] <= spans[name]["start_ns"] \
            <= spans[name]["end_ns"] <= outer["end_ns"]
    assert spans["tp.inner"]["end_ns"] <= spans["tp.second"]["start_ns"]
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    tids = {e["name"]: e["tid"] for e in events
            if e.get("ph") == "X" and e.get("name") in spans}
    assert set(tids) == set(spans)
    assert set(tids.values()) == {threading.get_native_id()} \
        == {s["thread"] for s in spans.values()}


def test_a_device_span_on_the_cpu_is_its_host_time():
    with _profiler():
        with tprof.annotate("tp.dev", device=True, rows=5):
            time.sleep(0.002)
    rec = tprof.recorded()
    (span,), (dev,) = rec["spans"], rec["device"]
    assert dev["id"] == span["id"] and dev["args"] == {"rows": 5}
    assert dev["ms"] == pytest.approx(
        (span["end_ns"] - span["start_ns"]) * 1e-6)
    assert dev["ms"] >= 2.0


def test_samples_are_kept_only_while_tracing():
    tprof.observe("tp.sample", 1.0)
    with _profiler():
        tprof.observe("tp.sample", 2.5, request=7)
    tprof.observe("tp.sample", 3.0)
    (sample,) = tprof.recorded()["samples"]
    assert sample["value"] == 2.5 and sample["args"] == {"request": 7}
    assert sample["thread"] == threading.get_native_id()


def test_spans_of_a_thread_started_before_the_profiler_are_recorded():
    go, done = threading.Event(), threading.Event()

    def work():
        go.wait(10)
        with tprof.annotate("tp.worker"):
            with tprof.annotate("tp.worker.inner"):
                pass
        done.set()

    t = threading.Thread(target=work)
    t.start()
    with _profiler():
        go.set()
        assert done.wait(10)
    t.join(10)
    assert not t.is_alive()
    spans = {s["name"]: s for s in tprof.recorded()["spans"]}
    assert spans["tp.worker"]["thread"] == t.native_id
    assert spans["tp.worker"]["parent"] is None
    assert spans["tp.worker.inner"]["parent"] == spans["tp.worker"]["id"]


# -- where the work happens -----------------------------------------------------

@pytest.mark.parametrize("buckets", [(1,), (1, 4, 8)])
def test_server_spans_and_queue_waits(buckets):
    def fn(batch):
        time.sleep(0.001)
        return batch + 1.0

    n = 13
    done = [None] * n
    with BatchingServer(fn, batch_buckets=buckets, max_wait_ms=20) as srv:
        before = (srv.stats.batches, srv.stats.batched_requests,
                  srv.stats.padded_rows)
        with _profiler():
            futs, sent = [], []
            for k, clip in enumerate(_clips(n)):
                sent.append(time.perf_counter_ns())
                fut = srv.submit(clip)
                fut.add_done_callback(
                    lambda f, k=k: done.__setitem__(k, time.perf_counter_ns()))
                futs.append(fut)
            for f in futs:
                f.result(timeout=10)
        stats = srv.stats
        delta = (stats.batches - before[0],
                 stats.batched_requests - before[1],
                 stats.padded_rows - before[2])
        collector = srv._worker.native_id
    rec = tprof.recorded()
    waits = _named(rec["samples"], "serve.queue_wait_s")
    assert sorted(s["args"]["request"] for s in waits) == list(range(n))
    for s in waits:
        k = s["args"]["request"]
        assert 0.0 <= s["value"] <= (done[k] - sent[k]) * 1e-9
    dispatch = _named(rec["spans"], "serve.dispatch")
    rows = [d["args"]["rows"] for d in dispatch]
    pads = [d["args"]["bucket"] - d["args"]["rows"] for d in dispatch]
    assert delta == (len(dispatch), sum(rows), sum(pads)) and sum(rows) == n
    assert all(d["args"]["bucket"] in buckets for d in dispatch)
    assert len({d["args"]["batch"] for d in dispatch}) == len(dispatch)
    by_id = {d["id"]: d for d in dispatch}
    for child in ("serve.stack", "serve.model", "serve.unstack",
                  "serve.resolve"):
        spans = _named(rec["spans"], child)
        assert len(spans) == len(dispatch)
        for s in spans:
            d = by_id[s["parent"]]
            assert s["thread"] == d["thread"] == collector
            assert d["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= d["end_ns"]
    assert len(_named(rec["device"], "serve.model")) == len(dispatch)
    assert _named(rec["spans"], "serve.hold")


def test_lift_spans_split_the_call():
    mb = MotionBERT(_tiny_model(), maxlen=9)
    x = _clips(3)
    want = mb.lift(x)
    with _profiler():
        got = mb.lift(x)
    np.testing.assert_array_equal(got, want)
    rec = tprof.recorded()
    assert [s["name"] for s in rec["spans"]] == \
        ["lift.h2d", "lift.forward", "lift.d2h"]
    (fwd,) = rec["device"]
    assert fwd["name"] == "lift.forward" and \
        fwd["args"] == {"rows": 3, "graph": 0}
    assert fwd["ms"] > 0


@pytest.mark.parametrize("has_3d", [True, False])
def test_train_step_spans(has_3d):
    torch.manual_seed(0)
    model = _tiny_model()
    step = make_train_step(model, make_adamw(model.parameters(), 1e-3, 0.01),
                           {"lambda_3d_velocity": 1.0}, rootrel=True,
                           no_conf=False)
    x = torch.from_numpy(_clips(2))
    with _profiler():
        for _ in range(2):
            terms = step(x, x, has_3d=has_3d)
    assert all(math.isfinite(float(v)) for v in terms.values())
    rec = tprof.recorded()
    steps = _named(rec["spans"], "train.step")
    assert len(steps) == 2
    children = ("train.forward", "train.backward", "train.optimizer")
    for name in children:
        spans = _named(rec["spans"], name)
        assert len(spans) == 2
        for s, parent in zip(spans, steps):
            assert s["parent"] == parent["id"]
            assert parent["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= parent["end_ns"]
    assert sorted(d["name"] for d in rec["device"]) == \
        sorted(["train.step", *children] * 2)


def test_device_prefetch_on_the_cpu_records_no_feed():
    batches = [(np.full((2, 3), i, np.float32), np.zeros(2, np.float32))
               for i in range(4)]
    with _profiler():
        got = list(device_prefetch(iter(batches), "cpu"))
    assert [float(x[0, 0]) for x, _ in got] == [0.0, 1.0, 2.0, 3.0]
    assert tprof.recorded()["spans"] == []


# -- the benchmark's readers ----------------------------------------------------

@pytest.fixture(scope="module")
def window():
    """What a traced window of each cell records, on the CPU: lifts through
    ``MotionBERTServer`` and train steps fed through ``data.feed`` spans,
    as the CUDA path of ``device_prefetch`` records them."""
    tprof.reset()
    model = _tiny_model()
    step = make_train_step(model, make_adamw(model.parameters(), 1e-3, 0.01),
                           {}, rootrel=True, no_conf=False)
    x = torch.from_numpy(_clips(2))
    with MotionBERTServer(MotionBERT(_tiny_model(), maxlen=9),
                          batch_buckets=(1, 4), max_wait_ms=5) as srv:
        with _profiler():
            for f in [srv.lift(c) for c in _clips(6)]:
                f.result(timeout=30)
            for _ in range(2):
                with tprof.annotate("data.feed"):
                    batch = x.clone()
                step(batch, batch)
    rec = tprof.recorded()
    tprof.reset()
    return rec


@pytest.mark.parametrize("kind,name", [(k, n) for k, names in READERS.items()
                                       for n in names])
def test_readers_read_only_their_cell_and_a_recorded_window(
        kind, name, window, monkeypatch):
    read = spec.reader(name)
    other = "train" if kind == "serve" else "serve"
    assert read({}) is None
    monkeypatch.setattr(tprof, "recorded", lambda: window)
    assert read({"kind": other, "steps": 2}) is None
    value = read({"kind": kind, "steps": 2})
    assert value is not None and math.isfinite(value) and value >= 0
    assert read({"kind": kind, "steps": 2}) == value


# -- trace ------------------------------------------------------------------------

def test_trace_writes_a_chrome_trace_with_the_regions(tmp_path):
    x = torch.ones(64, 64)
    with tprof.trace(str(tmp_path)):
        with tprof.annotate("tp_region_under_trace"):
            (x @ x).sum()
    files = sorted(os.listdir(tmp_path))
    assert files == ["spans.rank0.json", "trace.rank0.json"]
    events = json.loads((tmp_path / files[1]).read_text())["traceEvents"]
    assert any(e.get("name") == "tp_region_under_trace" for e in events)


def test_trace_resets_the_recorder_and_writes_its_spans(tmp_path):
    with _profiler():
        with tprof.annotate("tp.before"):
            pass
    assert tprof.recorded()["spans"]
    with tprof.trace(str(tmp_path)):
        with tprof.annotate("tp.during", device=True, rows=1):
            pass
        tprof.observe("tp.sample", 4.0)
    got = json.loads((tmp_path / "spans.rank0.json").read_text())
    assert [s["name"] for s in got["spans"]] == ["tp.during"]
    assert [s["name"] for s in got["device"]] == ["tp.during"]
    assert [s["value"] for s in got["samples"]] == [4.0]


def test_trace_records_the_regions_of_other_threads(tmp_path):
    go, done = threading.Event(), threading.Event()

    def work():
        go.wait(10)
        with tprof.annotate("tp_worker_region"):
            torch.ones(8).sum()
        done.set()

    t = threading.Thread(target=work)
    t.start()
    with tprof.trace(str(tmp_path)):
        go.set()
        assert done.wait(10)
    t.join(10)
    assert not t.is_alive()
    events = json.loads((tmp_path / "trace.rank0.json").read_text())[
        "traceEvents"]
    assert [e["tid"] for e in events if e.get("ph") == "X"
            and e.get("name") == "tp_worker_region"] == [t.native_id]


def test_trace_reads_the_environment(tmp_path, monkeypatch):
    monkeypatch.setenv("MOTIONBERT_PROFILE_DIR", str(tmp_path / "env"))
    with tprof.trace():
        torch.ones(4).sum()
    assert sorted(os.listdir(tmp_path / "env")) == \
        ["spans.rank0.json", "trace.rank0.json"]


def test_trace_without_a_directory_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.delenv("MOTIONBERT_PROFILE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    for mod in (tprof, jprof):
        with mod.trace():
            torch.ones(4).sum()
    assert os.listdir(tmp_path) == []
