"""Tracing and profiling: named regions, a device trace, step timers.

The port of ``motionbert_tpu/core/profiling.py`` on ``torch.profiler``
(the reference has only manual AverageMeter timers):

- ``annotate(name)``: a context manager that marks a named region in the
  trace (``torch.profiler.record_function``, and an NVTX range when a card
  is present) and accumulates the region's host wall time in ``REGIONS``.
- ``StepTimer``: data-time and step-time meters, as the reference's train
  loops keep them.
- ``trace(logdir)``: a ``torch.profiler`` capture of the host and, with a
  card, of CUDA, written as one Chrome trace per rank
  (``trace.rank<r>.json``) into ``logdir``, or into
  ``MOTIONBERT_PROFILE_DIR`` when no directory is given; with neither it
  captures nothing.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


class _Accumulator:
    def __init__(self):
        self.total = defaultdict(float)
        self.count = defaultdict(int)

    def add(self, name, dt):
        self.total[name] += dt
        self.count[name] += 1

    def summary(self):
        return {
            name: {"total_s": self.total[name], "count": self.count[name],
                   "mean_ms": 1000.0 * self.total[name] / self.count[name]}
            for name in self.total
        }


REGIONS = _Accumulator()


@contextlib.contextmanager
def annotate(name: str):
    """Named region: shows up in traces and host accounting."""
    nvtx = torch.cuda.is_available()
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()
    REGIONS.add(name, time.perf_counter() - t0)


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """Capture a profile of the host and the card (viewable in perfetto or
    chrome://tracing) into ``logdir`` (or ``MOTIONBERT_PROFILE_DIR``)."""
    from torch.profiler import ProfilerActivity, profile

    from motionbert_tpu_torch.parallel.mesh import rank

    logdir = logdir or os.environ.get("MOTIONBERT_PROFILE_DIR")
    if not logdir:
        yield
        return
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir,
                                              f"trace.rank{rank()}.json"))


class StepTimer:
    """data_time / step_time meters (reference train_action.py:167-188)."""

    def __init__(self):
        self.data_time = 0.0
        self.step_time = 0.0
        self.steps = 0
        self._last = time.perf_counter()

    def data_ready(self):
        now = time.perf_counter()
        self.data_time += now - self._last
        self._last = now

    def step_done(self):
        now = time.perf_counter()
        self.step_time += now - self._last
        self._last = now
        self.steps += 1

    def summary(self):
        n = max(self.steps, 1)
        return {"steps": self.steps,
                "data_ms": 1000.0 * self.data_time / n,
                "step_ms": 1000.0 * self.step_time / n}
