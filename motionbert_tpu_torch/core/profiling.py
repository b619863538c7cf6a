"""Tracing: the program's spans and samples, recorded only while a torch
profiler runs, and a device trace for an operator.

Tracing is on exactly while a ``torch.profiler`` profile (or
``torch.autograd.profiler.emit_nvtx``) runs in the process: the gate is
``torch.autograd.profiler._is_profiler_enabled``, which the profiler's
thread sets and every thread reads. Off, a span or a sample costs that one
check: no ``record_function``, no NVTX range, no clock read, no event.

- ``annotate(name, device=False, **args)``: a span. On, it enters
  ``torch.profiler.record_function(name)``, so the span lands in the
  profiler's Chrome trace on the clock of its kernels, and appends to the
  recorder its name, id, the id of the enclosing span on the same thread
  (``parent``), the thread (its native id, the Chrome trace's ``tid``),
  ``args`` and its start and end on ``time.perf_counter_ns()``. A profiler
  records the host regions of its own thread only, unless it was started
  with ``profile_all_threads``, as ``trace`` starts it; the recorder holds
  every thread's spans either way.
  With ``device=True`` and CUDA initialised the span also records a pair of
  timing events on the current stream, resolved to milliseconds only when
  read; without CUDA its device time is its host time.
- ``observe(name, value, **args)``: a sample, appended while tracing is on.
- ``recorded()``: the spans, the device spans (waiting for their events)
  and the samples recorded since the last ``reset()``.
- ``trace(logdir)``: a ``torch.profiler`` capture of the host (every
  thread) and, with a card, of CUDA, written as one Chrome trace per rank
  (``trace.rank<r>.json``) into ``logdir``, or into
  ``MOTIONBERT_PROFILE_DIR`` when no directory is given, with the
  recorder's spans beside it (``spans.rank<r>.json``); with neither it
  captures nothing.

For NVTX ranges (read by Nsight Systems) wrap the run in
``torch.autograd.profiler.emit_nvtx()``: it turns the same
``record_function`` ranges into NVTX ranges, and turns tracing on.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

_OFF = contextlib.nullcontext()


class _Recorder:
    """Spans, pending device spans and samples of every thread."""

    def __init__(self):
        self.lock = threading.Lock()
        self.ids = itertools.count(1)
        self.stacks = threading.local()   # each thread's open span ids
        self.reset()

    def reset(self):
        with self.lock:
            self.spans, self.samples = [], []
            self.device, self.pending = [], []   # resolved / (span, events)


_REC = _Recorder()


def tracing() -> bool:
    """Whether a torch profiler runs in the process."""
    return _autograd_profiler._is_profiler_enabled


class _Span:
    __slots__ = ("name", "device", "args", "span", "events", "fn", "t0")

    def __init__(self, name: str, device: bool, args: dict):
        self.name, self.device, self.args = name, device, args

    def __enter__(self):
        stack = getattr(_REC.stacks, "ids", None)
        if stack is None:
            stack = _REC.stacks.ids = []
        span_id = next(_REC.ids)
        self.span = {"name": self.name, "id": span_id,
                     "parent": stack[-1] if stack else None,
                     "thread": threading.get_native_id(), "args": self.args}
        stack.append(span_id)
        self.fn = torch.profiler.record_function(self.name)
        self.fn.__enter__()
        self.events = None
        if self.device and torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record()
        self.fn.__exit__(*exc)
        _REC.stacks.ids.pop()
        span = self.span
        span["start_ns"], span["end_ns"] = self.t0, t1
        with _REC.lock:
            _REC.spans.append(span)
            if self.events is not None:
                _REC.pending.append((span, self.events))
            elif self.device:
                _REC.device.append(_device_span(span, (t1 - self.t0) * 1e-6))
        return False


def _device_span(span: dict, ms: float) -> dict:
    return {"name": span["name"], "id": span["id"], "args": span["args"],
            "ms": ms}


def annotate(name: str, device: bool = False, **args):
    """A named span of the program (see the module's docstring)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, device, args)


def observe(name: str, value: float, **args) -> None:
    """A sample of ``name``, kept while tracing is on."""
    if _autograd_profiler._is_profiler_enabled:
        sample = {"name": name, "value": float(value),
                  "thread": threading.get_native_id(),
                  "t_ns": time.perf_counter_ns(), "args": args}
        with _REC.lock:
            _REC.samples.append(sample)


def recorded() -> dict:
    """``{"spans", "device", "samples"}`` since the last ``reset()``; the
    device spans' events are waited for and resolved to ``ms`` here."""
    with _REC.lock:
        pending, _REC.pending = _REC.pending, []
        for span, (a, b) in pending:
            b.synchronize()
            _REC.device.append(_device_span(span, a.elapsed_time(b)))
        return {"spans": list(_REC.spans), "device": list(_REC.device),
                "samples": list(_REC.samples)}


def reset() -> None:
    """Forget every span and sample recorded so far."""
    _REC.reset()


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """Capture a profile of the host and the card (viewable in perfetto or
    chrome://tracing) into ``logdir`` (or ``MOTIONBERT_PROFILE_DIR``), and
    the spans recorded meanwhile beside it."""
    from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile

    from motionbert_tpu_torch.parallel.mesh import rank

    logdir = logdir or os.environ.get("MOTIONBERT_PROFILE_DIR")
    if not logdir:
        yield
        return
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities, experimental_config=
                   _ExperimentalConfig(profile_all_threads=True))
    reset()
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        r = rank()
        prof.export_chrome_trace(os.path.join(logdir, f"trace.rank{r}.json"))
        with open(os.path.join(logdir, f"spans.rank{r}.json"), "w") as f:
            json.dump(recorded(), f)
