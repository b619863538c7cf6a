"""The device trace of a measured window, and its reduction to records.

``Trace`` runs ``torch.profiler`` (host and CUDA) around the window, marks
the window with the annotation ``bench.window``, exports the Chrome trace
into the temporary directory and reads it back with ``reduce_events``,
which knows nothing of the profiler but the trace's event format:

- ``kernel``, ``gpu_memcpy``, ``gpu_memset``: device work (start, length);
- ``cuda_runtime`` / ``cuda_driver``: the host call that launched it, tied
  to it by ``args.correlation``;
- ``cpu_op``, ``user_annotation``: host regions, per thread.

The records: the window's length, the device's busy time (the union of its
work), the time of each kernel by name and of the program's own kernels
(named in its CUDA sources), the device time of the kernels launched under
a host region, and the idle gaps by what the launching thread was doing.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import re
import tempfile
from collections import defaultdict
from pathlib import Path

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
GAP_FLOOR_US = 20.0   # shorter gaps are counted, not attributed one by one
NO_REGION = "(no host op: python or waiting)"
SHORT_GAPS = "(gaps under 20 us)"


def port_kernel_names(csrc: Path) -> frozenset:
    """The names of the ``__global__`` functions in the program's CUDA
    sources."""
    pattern = re.compile(
        r"__global__\s+void\s+(?:__launch_bounds__\s*\((?:[^()]|\([^()]*\))*"
        r"\)\s*)?(\w+)\s*\(")
    names = set()
    for src in sorted(csrc.glob("*.cu*")):
        names.update(pattern.findall(src.read_text()))
    return frozenset(names)


def kernel_base(name: str) -> str:
    """The function's own name in a demangled kernel name:
    ``void (anonymous namespace)::hg_gemm_kernel<0, 1>(Params)`` ->
    ``hg_gemm_kernel``."""
    s = name.replace("(anonymous namespace)", "anon")
    s = s.split("(", 1)[0]
    out, depth = [], 0
    for ch in s:                      # drop template arguments
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(depth - 1, 0)
        elif depth == 0:
            out.append(ch)
    s = "".join(out).strip().split("::")[-1]
    return s.split()[-1] if s.split() else s


def _union(intervals: list) -> list:
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1][1] = b
        else:
            merged.append([a, b])
    return merged


def _innermost(events: list, queries: list) -> dict:
    """For one thread's nested host regions [(start, end, name)] and query
    times, the innermost region holding each time (or NO_REGION)."""
    events = sorted(events, key=lambda e: (e[0], -e[1]))
    out, stack, i = {}, [], 0
    for q in sorted(set(queries)):
        while i < len(events) and events[i][0] <= q:
            while stack and stack[-1][1] <= events[i][0]:
                stack.pop()
            stack.append(events[i])
            i += 1
        while stack and stack[-1][1] <= q:
            stack.pop()
        out[q] = stack[-1][2] if stack else NO_REGION
    return out


def reduce_events(events: list, port_names: frozenset,
                  regions: tuple = ()) -> dict:
    """Records of one traced window (see the module's docstring).
    ``regions``: host region name prefixes whose launched kernels' device
    time is summed (``region_device_s``)."""
    win = [e for e in events
           if e.get("ph") == "X" and e.get("name") == WINDOW]
    if not win:
        raise ValueError(f"no {WINDOW} annotation in the trace")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    main_tid = win[0].get("tid")
    device, launches, host = [], {}, defaultdict(list)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            device.append((ts, ts + dur, e.get("name", ""), cat,
                           (e.get("args") or {}).get("correlation")))
        elif cat in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = (e.get("tid"), ts)
        elif cat in HOST_CATS and e.get("name") != WINDOW:
            host[e.get("tid")].append((ts, ts + dur, e.get("name", "")))
    inside = [d for d in device if d[1] > w0 and d[0] < w1]
    busy = _union([(max(a, w0), min(b, w1)) for a, b, *_ in inside])
    busy_us = sum(b - a for a, b in busy)

    by_kernel = defaultdict(float)
    port_us = 0.0
    for a, b, name, cat, _ in inside:
        if cat != "kernel":
            name = f"[{cat}] {name}"
        by_kernel[name] += b - a
        if cat == "kernel" and kernel_base(name) in port_names:
            port_us += b - a

    region_us = {}
    for prefix in regions:
        spans = defaultdict(list)
        for tid, evs in host.items():
            spans[tid] = sorted((s, t) for s, t, n in evs
                                if n.startswith(prefix))
        total = 0.0
        for a, b, name, cat, corr in inside:
            tid, at = launches.get(corr, (None, None))
            ivs = spans.get(tid)
            if not ivs:
                continue
            k = bisect.bisect_right(ivs, (at, float("inf"))) - 1
            if k >= 0 and ivs[k][0] <= at <= ivs[k][1]:
                total += b - a
        region_us[prefix] = total

    # idle gaps: the window less the busy union, each named by what the
    # thread that launched the next device work was doing when it began
    gaps, edge = [], w0
    for a, b in busy:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    if w1 > edge:
        gaps.append((edge, w1))
    starts = sorted((d[0], d[4]) for d in inside)
    idle = defaultdict(float)
    queries = defaultdict(list)
    for a, b in gaps:
        if b - a < GAP_FLOOR_US:
            idle[SHORT_GAPS] += b - a
            continue
        k = bisect.bisect_left(starts, (b, -float("inf")))
        corr = starts[k][1] if k < len(starts) else None
        tid = launches.get(corr, (main_tid, None))[0]
        queries[tid].append((a, b))
    for tid, qs in queries.items():
        names = _innermost(host.get(tid, []), [a for a, _ in qs])
        for a, b in qs:
            idle[names[a]] += b - a
    top = lambda d: [[k, v * 1e-6] for k, v in
                     sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy_us * 1e-6,
            "port_kernel_s": port_us * 1e-6,
            "kernels": {k: v * 1e-6 for k, v in by_kernel.items()},
            "region_device_s": {k: v * 1e-6 for k, v in region_us.items()},
            "device_ops": top(by_kernel), "idle_gaps": top(idle)}


class Trace:
    """A profiler around the measured window, or nothing when ``on`` is
    false. Use ``with trace.window():`` around the window itself, then
    ``records()`` after the profiler has stopped."""

    def __init__(self, on: bool, port_names: frozenset, regions: tuple = ()):
        self.on, self.port_names, self.regions = on, port_names, regions
        self._prof = None

    def start(self):
        if not self.on:
            return
        import torch

        self._prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        self._prof.__enter__()

    def stop(self):
        if self._prof is not None:
            self._prof.__exit__(None, None, None)

    @contextlib.contextmanager
    def window(self):
        if not self.on:
            yield
            return
        import torch

        with torch.profiler.record_function(WINDOW):
            yield

    @contextlib.contextmanager
    def region(self, name: str):
        """A host region of the benchmark's own code, in the trace only."""
        if not self.on:
            yield
            return
        import torch

        with torch.profiler.record_function(name):
            yield

    def records(self) -> dict:
        fd, path = tempfile.mkstemp(suffix=".json", prefix="bench-trace-")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        return reduce_events(events, self.port_names, self.regions)
